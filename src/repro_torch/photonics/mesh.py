"""The MZI-mesh executor (counterpart of ``repro.photonics.mesh``).

``mzi.py`` is the numpy oracle: it rebuilds an orthogonal matrix by
multiplying one m x m Givens matrix per MZI.  Here a phase program is
compiled ONCE into stacked Clements-style rotation layers, each packing
its disjoint rotations into three full-width wire vectors (partner
permutation ``perm``, diagonal ``ca``, off-diagonal ``sa``; untouched
wires are identities), so one layer is

    y' = ca * y + sa * y[..., perm]

and a whole mesh, or B stacked meshes of one width, is one launch of
the ``mesh_scan`` kernel (``kernels.mesh_scan``: the CUDA kernel for
CUDA tensors, its plain version for CPU ones).

Layering: rotations are greedily scheduled in application order; a
rotation lands in layer ``max(last_layer[wire_i], last_layer[wire_j])+1``,
which preserves ordering between rotations sharing a waveguide and packs
commuting (disjoint) rotations into the same layer; for Clements-style
adjacent-plane programs this approaches the optimal ~2m-3 layer depth.

The programs are plain dataclasses of CPU tensors, compiled once;
``to(device)`` copies one to a device (``module.ONNModule.programs_on``
does that once per device).  A program with zero rotations skips the
kernel: every layer is an identity, the scan would compute 1 * y + 0 *
y[perm] = y bit for bit, so only the diagonals are applied, as in the
JAX executor.

``backend`` (``PhotonicsConfig.mesh_backend``) picks the PhaseNoise
model of the JAX executor it names; both run the one kernel
(``config.MESH_BACKENDS``).  With ``noise`` and a key, 'pallas' turns on
the kernel's in-kernel theta drift (``theta_std`` and uint32 seeds taken
from the key), and 'xla' drifts the (L, m) ``ca``/``sa`` stacks with
``PhaseNoise.perturb`` in tensor ops before a launch without drift.
Shot noise lands on the output of either, and is all a mesh without
rotations takes.  Keys split and fold as JAX's do (``prng``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from ..kernels.mesh_scan import mesh_scan, mesh_scan_blocks
from .config import MESH_BACKENDS
from .encoding import f32_reciprocal
from .mzi import MZIProgram


def _check_backend(backend: str | None) -> str:
    backend = backend or "xla"
    if backend not in MESH_BACKENDS:
        raise ValueError(f"mesh backend must be one of {MESH_BACKENDS}, "
                         f"got {backend!r}")
    return backend


def _noise_keys(noise, key):
    """(theta key, shot key), or (None, None) without noise or key."""
    if noise is not None and noise.enabled and key is not None:
        return tuple(prng.split(key))
    return None, None


def _drift_seeds(noise, k_theta, n: int, device):
    """The kernel's drift arguments: (theta_std, n uint32 seeds taken
    from ``k_theta``), or (0.0, None) when there is no drift."""
    if k_theta is None or noise.theta_drift_std <= 0.0:
        return 0.0, None
    return noise.theta_drift_std, torch.tensor(prng.bits32(k_theta, n),
                                               dtype=torch.int64,
                                               device=device)


def _schedule_layers(rotations, m):
    """Greedy dependency-preserving layering of (i, j, theta) rotations
    given in APPLICATION order.  Returns a list of layers (lists)."""
    last = [-1] * m
    layers = []
    for (i, j, theta) in rotations:
        at = max(last[i], last[j]) + 1
        if at == len(layers):
            layers.append([])
        layers[at].append((i, j, theta))
        last[i] = last[j] = at
    return layers


@dataclasses.dataclass
class MZIMesh:
    """One orthogonal matrix as a compiled rotation-layer stack.

    Represents o = G_1^T ... G_K^T diag(signs) (the ``mzi.reconstruct``
    convention); ``apply`` computes o @ x (or o^T @ x) on the last axis
    of ``x``, broadcasting over leading batch dims.  ``_stack_meshes``
    gives the layer tensors a leading block axis."""
    dim: int
    n_rot: int                # real MZI rotations in the program
    signs: torch.Tensor       # (m,)
    perm: torch.Tensor        # (L, m) int32 partner wire (self = untouched)
    ca: torch.Tensor          # (L, m) diagonal coefficient (cos theta / 1)
    sa: torch.Tensor          # (L, m) off-diagonal coefficient (-+ sin / 0)

    @property
    def num_rotations(self) -> int:
        return self.n_rot

    @property
    def depth(self) -> int:
        """Optical depth: rotation layers behind one another."""
        return int(self.perm.shape[-2])

    def to(self, device) -> "MZIMesh":
        return dataclasses.replace(self, signs=self.signs.to(device),
                                   perm=self.perm.to(device),
                                   ca=self.ca.to(device),
                                   sa=self.sa.to(device))

    @classmethod
    def compile(cls, program: MZIProgram, dtype=torch.float32) -> "MZIMesh":
        """Layer, pad, and stack an ``MZIProgram`` into layer tensors on
        the CPU (float64 for the oracle tests, float32 for the kernel)."""
        m = program.dim
        # application order for o @ x: diag(signs) first, then G_K^T..G_1^T
        layers = _schedule_layers(list(reversed(program.rotations)), m)
        if not layers:
            layers = [[]]
        n_layers = len(layers)
        perm = np.tile(np.arange(m, dtype=np.int32), (n_layers, 1))
        ca = np.ones((n_layers, m), np.float64)
        sa = np.zeros((n_layers, m), np.float64)
        for li, layer in enumerate(layers):
            for (i, j, t) in layer:
                c, s = np.cos(t), np.sin(t)
                perm[li, i], perm[li, j] = j, i
                ca[li, i] = ca[li, j] = c
                # G^T:  y_i' = c y_i - s y_j ;  y_j' = s y_i + c y_j
                sa[li, i], sa[li, j] = -s, s
        return cls(dim=m, n_rot=len(program.rotations),
                   signs=torch.tensor(np.asarray(program.signs), dtype=dtype),
                   perm=torch.from_numpy(perm),
                   ca=torch.from_numpy(ca).to(dtype),
                   sa=torch.from_numpy(sa).to(dtype))

    def apply(self, x: torch.Tensor, transpose: bool = False,
              backend: str | None = None,
              post_scale: torch.Tensor | None = None,
              noise=None, key=None, blk_b: int = 0) -> torch.Tensor:
        """o @ x (or o^T @ x when ``transpose``) over the last axis, times
        the diagonal epilogue ``post_scale`` when given: one launch of
        the ``mesh_scan`` kernel with ``blk_b`` its row tile.  ``noise``
        (a ``pipeline.PhaseNoise``) + ``key`` inject the theta drift and
        shot noise as the executor ``backend`` models them (module
        docstring)."""
        backend = _check_backend(backend)
        k_theta, k_shot = _noise_keys(noise, key)
        if self.n_rot == 0:
            y = x.to(self.ca.dtype) * self.signs
            if post_scale is not None:
                y = y * post_scale
            return y if k_shot is None else noise.shot(k_shot, y)
        ca, sa, theta_std, seed = self.ca, self.sa, 0.0, None
        if backend == "pallas":
            theta_std, seed = _drift_seeds(noise, k_theta, 1, x.device)
        elif k_theta is not None:
            ca, sa = noise.perturb(k_theta, self.perm, ca, sa)
        y = mesh_scan(self.signs, self.perm, ca, sa,
                      x.to(self.ca.dtype).contiguous(), transpose=transpose,
                      post_scale=post_scale, blk_b=blk_b,
                      theta_std=theta_std, seed=seed)
        return y if k_shot is None else noise.shot(k_shot, y)

    def matrix(self) -> torch.Tensor:
        """Rebuild the dense orthogonal matrix (``mzi.reconstruct``)."""
        return self.apply(torch.eye(self.dim, dtype=self.ca.dtype,
                                    device=self.ca.device)).T


def reconstruct(program: MZIProgram, dtype=torch.float32) -> torch.Tensor:
    """Counterpart of ``mzi.reconstruct`` through the executor."""
    return MZIMesh.compile(program, dtype).matrix()


def _stack_meshes(meshes) -> MZIMesh:
    """Stack same-dim MZIMesh programs along a leading block axis, padding
    every program to the deepest layer count with identity layers."""
    dim = meshes[0].dim
    assert all(m.dim == dim for m in meshes)
    depth = max(m.depth for m in meshes)

    def pad(mesh):
        n = depth - mesh.depth
        ident = torch.arange(dim, dtype=mesh.perm.dtype).repeat(n, 1)
        return (torch.cat([mesh.perm, ident]),
                torch.cat([mesh.ca, torch.ones((n, dim), dtype=mesh.ca.dtype)]),
                torch.cat([mesh.sa, torch.zeros((n, dim),
                                                dtype=mesh.sa.dtype)]))

    padded = [pad(m) for m in meshes]
    return MZIMesh(dim=dim, n_rot=sum(m.n_rot for m in meshes),
                   signs=torch.stack([m.signs for m in meshes]),
                   perm=torch.stack([p[0] for p in padded]),
                   ca=torch.stack([p[1] for p in padded]),
                   sa=torch.stack([p[2] for p in padded]))


def _apply_stacked(stacked: MZIMesh, x: torch.Tensor, x_block_axis: bool,
                   backend: str | None = None,
                   post_scale: torch.Tensor | None = None,
                   noise=None, key=None, blk_b: int = 0) -> torch.Tensor:
    """Apply a stacked mesh over its block axis: ONE launch of
    ``mesh_scan_blocks``.  ``x`` is shared across blocks (tall layers) or
    carries its own block axis at -2 (wide layers); ``post_scale``
    (B, dim) is each block's diagonal epilogue.  Returns (..., B, dim).
    A stack with zero rotations in all its blocks skips the kernel.

    With ``noise`` and ``key``: 'pallas' draws the theta drift in-kernel
    from per-block seeds and the shot noise over the whole output, as
    the JAX kernel path does; 'xla' gives every block its own key, as
    JAX's vmap over the per-block apply does, and each block's key its
    own drift of the block's stacks and its own shot noise."""
    backend = _check_backend(backend)
    x = x.to(stacked.ca.dtype)
    n_blocks = stacked.signs.shape[0]
    k_theta, k_shot = _noise_keys(noise, key)
    if stacked.n_rot == 0:
        y = (x if x_block_axis else x[..., None, :]) * stacked.signs
        if post_scale is not None:
            y = y * post_scale
        return y if k_shot is None else noise.shot(k_shot, y)
    ca, sa, theta_std, seeds = stacked.ca, stacked.sa, 0.0, None
    block_keys = []
    if backend == "pallas":
        theta_std, seeds = _drift_seeds(noise, k_theta, n_blocks, x.device)
    elif k_theta is not None:
        block_keys = [prng.split(k) for k in prng.split(key, n_blocks)]
        if noise.theta_drift_std > 0.0:
            g = torch.stack([prng.normal(kt, stacked.perm.shape[1:],
                                         ca.dtype, ca.device)
                             for kt, _ in block_keys])
            ca, sa = noise.perturb_with(g, stacked.perm, ca, sa)
    y = mesh_scan_blocks(stacked.signs, stacked.perm, ca, sa, x.contiguous(),
                         x_block_axis=x_block_axis, post_scale=post_scale,
                         blk_b=blk_b, theta_std=theta_std, seeds=seeds)
    if backend == "pallas":
        return y if k_shot is None else noise.shot(k_shot, y)
    if block_keys and noise.shot_noise_std > 0.0:
        y = torch.stack([noise.shot(ks, y[..., b, :])
                         for b, (_, ks) in enumerate(block_keys)], dim=-2)
    return y


# ---------------- compiled ONN hardware programs (layer level) ----------------

@dataclasses.dataclass
class SVDLayerProgram:
    """W = U Sigma V^T on two meshes + one diagonal column (paper eq. 1)."""
    shape: tuple
    u: MZIMesh
    v: MZIMesh
    sigma: torch.Tensor
    b: torch.Tensor

    @property
    def num_mzis(self) -> int:
        return (self.u.num_rotations + self.v.num_rotations
                + int(self.sigma.shape[0]))

    def to(self, device) -> "SVDLayerProgram":
        return dataclasses.replace(self, u=self.u.to(device),
                                   v=self.v.to(device),
                                   sigma=self.sigma.to(device),
                                   b=self.b.to(device))

    def apply(self, x: torch.Tensor, backend: str | None = None,
              noise=None, key=None, blk_b: int = 0) -> torch.Tensor:
        kv, ku = (None, None) if key is None else prng.split(key)
        m, _ = self.shape
        k = self.sigma.shape[0]
        z = self.v.apply(x, transpose=True, backend=backend, noise=noise,
                         key=kv, blk_b=blk_b)[..., :k] * self.sigma
        if m > k:
            z = torch.cat([z, z.new_zeros(z.shape[:-1] + (m - k,))], dim=-1)
        return self.u.apply(z, backend=backend, noise=noise, key=ku,
                            blk_b=blk_b) + self.b


@dataclasses.dataclass
class ApproxLayerProgram:
    """Sigma_a U_a blocks (paper eq. 4): one mesh + diag column per block."""
    shape: tuple
    meshes: MZIMesh           # stacked along a leading block axis
    d: torch.Tensor           # (n_blocks, s)
    b: torch.Tensor

    @property
    def num_mzis(self) -> int:
        n_blocks, s = self.d.shape
        return self.meshes.num_rotations + n_blocks * s

    def to(self, device) -> "ApproxLayerProgram":
        return dataclasses.replace(self, meshes=self.meshes.to(device),
                                   d=self.d.to(device), b=self.b.to(device))

    def apply(self, x: torch.Tensor, backend: str | None = None,
              noise=None, key=None, blk_b: int = 0) -> torch.Tensor:
        # the Sigma_a diagonal rides as the kernel's fused epilogue
        m, n = self.shape
        s = min(m, n)
        if m >= n:
            ys = _apply_stacked(self.meshes, x, x_block_axis=False,
                                backend=backend, post_scale=self.d,
                                noise=noise, key=key, blk_b=blk_b)
            return ys.reshape(x.shape[:-1] + (m,)) + self.b
        ys = _apply_stacked(self.meshes, x.reshape(x.shape[:-1] + (n // s, s)),
                            x_block_axis=True, backend=backend,
                            post_scale=self.d, noise=noise, key=key,
                            blk_b=blk_b)
        # the block sum one block after another, as XLA reduces it
        y = ys[..., 0, :]
        for j in range(1, ys.shape[-2]):
            y = y + ys[..., j, :]
        return y + self.b


def _tensor(v, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(v), dtype=dtype)


def compile_layer(hw_layer, dtype=torch.float32):
    """Compile one ``onn.map_to_hardware`` layer dict to a program of CPU
    tensors."""
    if hw_layer["kind"] == "svd":
        return SVDLayerProgram(
            shape=tuple(hw_layer["shape"]),
            u=MZIMesh.compile(hw_layer["u"], dtype),
            v=MZIMesh.compile(hw_layer["v"], dtype),
            sigma=_tensor(hw_layer["sigma"], dtype),
            b=_tensor(hw_layer["b"], dtype))
    blocks = hw_layer["blocks"]
    return ApproxLayerProgram(
        shape=tuple(hw_layer["shape"]),
        meshes=_stack_meshes([MZIMesh.compile(blk["u"], dtype)
                              for blk in blocks]),
        d=torch.stack([_tensor(blk["d"], dtype) for blk in blocks]),
        b=_tensor(hw_layer["b"], dtype))


def compile_hardware(hw, dtype=torch.float32) -> list:
    """Compile the full ``onn.map_to_hardware`` program list."""
    return [compile_layer(layer, dtype) for layer in hw]


def apply_hardware(programs, a: torch.Tensor, cfg,
                   backend: str | None = None, noise=None, key=None,
                   blk_b: int = 0) -> torch.Tensor:
    """Forward pass through the compiled MZI meshes, the fast counterpart
    of ``onn.apply_hardware`` (the numpy oracle).  The input scaling is
    the product with the reciprocal of ``in_scale``, as XLA compiles the
    JAX division (f32), and a plain division in f64.  ``noise`` + ``key``
    thread the PhaseNoise model into every layer's meshes (one key per
    layer, folded off ``key``)."""
    dt = programs[0].b.dtype
    x = a.to(dt)
    x = x * f32_reciprocal(cfg.in_scale) if dt == torch.float32 \
        else x / cfg.in_scale
    for li, prog in enumerate(programs):
        k = None if key is None else prng.fold_in(key, li)
        x = prog.apply(x, backend=backend, noise=noise, key=k, blk_b=blk_b)
        if li < len(programs) - 1:
            x = torch.relu(x)
    return x * cfg.out_scale
