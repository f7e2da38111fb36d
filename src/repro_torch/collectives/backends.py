"""Collective backends of the port: psum | ring | optinc | cascade
(counterpart of ``repro.collectives.backends``).

Each backend synchronizes ONE fused f32 bucket of the stacked peers,
``x``: (*peers, elems) with one leading dimension a sync axis of
``cfg.axes`` ((N, elems) over 'data', (pods, dp, elems) over ('pod',
'data'); peer p = pod * dp + d), and models its own wire bytes
(``bytes_on_wire``) and wire time (``time_on_wire``) exactly as the JAX
package does.

OptINC, per bucket: the shared block scale is the max over peers of each
peer's per-block max-abs (JAX: ``compute_scale`` then ``lax.pmax``);
the pam4 encode kernel turns the (N, elems) stack into B-bit
offset-binary codes; the optical fabric's integer sum is an int32 sum
over the peers (JAX: reduce-scatter and all-gather of the codes); the
pam4 decode kernel applies Q(mean) (eq. 3) and dequantizes; and, with
error feedback on, the same decode kernel at n = 1 gives each peer's
input minus its locally quantized gradient, the error-feedback term.
Integer sums are exact in any order, so the result is bit-identical to
the JAX package's on the same input bucket.

With ``cfg.error_layers`` (Table II, ``photonics.error_model``) the
averaged codes must exist between Q(mean) and the dequantize: Q(mean)
in tensor ops, the injection, then the decode kernel at n = 1.  The JAX
step injects after its reduce-scatter, so each of the N devices injects
into its own shard of ceil(L / N) codes with the same bucket key: every
shard gets the same hit pattern, and so does the port (one draw of shard
length, applied to each of the N shards).

The cascade (paper III-C, eq. 10) at fidelity 'behavioral' is the same
quantized path over all pods * dp peers: level 1 carries the exact
integer partial sums, level 2 sums them and quantizes once, and integer
sums do not depend on their order.  With one sync axis it is optinc (an
elastic shrink to one pod).

At fidelity 'onn' or 'mesh' the Q(mean) step is the in-network ONN
instead (``_photonic_sync``): after the same shared scale and encode,
the codes run one ``photonics.pipeline`` level (PAM4 symbols, unit P
over the peers, the ONN: dense with every layer one ``onn_layer``
launch, or its MZI meshes with every mesh stack one ``mesh_scan``
launch; the transceiver readout, symbol decode), and ``_finish``
dequantizes the averaged codes with the pam4 decode kernel at n = 1
(Q(mean) of one code is the code), as the behavioral path dequantizes
its code sums.  The photonic cascade (``_photonic_cascade_sync``) runs
two such levels: level 0 over each pod's dp peers, emitting the eq.-10
carry, for all pods in one pipeline run; level 1 over the pods.

The ring (the paper's baseline) sums the f32 buckets in the order a
ring all-reduce does, one sync axis after another, and multiplies by
f32(1/N) as XLA compiles JAX's division by N.

At fidelity 'mesh' with noise stds set, the pipeline runs the PhaseNoise
model (``photonics.pipeline.PhaseNoise``) from a key folded off the
bucket's sync key (``_noise_key``), so every step and bucket draws its
own noise; Table-II injection draws from the raw bucket key.

Peers as processes (``world``, a ``launch.distributed.ProcessAxes``):
each backend takes this rank's (1, m) row and runs the collectives of
JAX's shard-local program over the named axes.  psum: an all-reduce,
then the stacked path's division (NCCL sums in its own order, so psum
is held to a tolerance).  ring: JAX's ``_ring_allreduce_flat`` over
'pod', then 'data', its 2(N - 1) ``ppermute`` rounds each a send to the
next rank of the axis, the same chunks and f32 order as ``_ring_sum``.
optinc and the behavioral cascade (``_quantized_sync_ranks``): the
rank's ``compute_scale`` and a ``pmax``, the encode of its row, the
reduce-scatter plan of JAX (``_scatter_plan``: every axis in 16-bit
lanes where JAX picks int16, else int32; the cascade 'data' first, then
'pod' in int32) over shards of ceil(L / N) codes, Q(mean) and the
Table-II injection on the shard (the raw bucket key: every rank draws
the same pattern, as every JAX device does), the all-gather of the
averaged codes as uint8 (uint16 above 8 bits), then the decode at n = 1
and, with error feedback, the rank's own residual row.  The photonic
paths run the same pipeline levels with ``Preprocess`` summing over the
level's axes (``world``, ``axes``); every rank then runs the whole ONN
on the whole bucket, and in the cascade every pod draws the same
level-0 noise, as in JAX.  Integer sums are exact in any order, so
every mode but psum is bit-equal to the stacked path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import prng
from ..kernels.pam4 import pam4_decode_dequantize, pam4_quantize_encode
from ..photonics import error_model
from ..photonics import pipeline as ph_pipeline
from ..photonics import runtime as ph_runtime
from ..photonics.cascade import extra_symbols
from ..photonics.encoding import (QuantSpec, compute_scale, f32_reciprocal,
                                  num_symbols)
from .bucketizer import DEFAULT_BUCKET_BYTES, expected_buckets
from .registry import register_backend

WIRE_BYTES_PER_S = 100e9     # one 800 Gb/s full-duplex optical transceiver
MESH_RECONFIG_S = 20e-6      # programming one MZI mesh circuit
HOP_LATENCY_S = 1e-6         # one electrical ppermute round (ring baseline)


def _n_buckets(nbytes: float, bucket_bytes: int) -> int:
    return max(expected_buckets(int(max(nbytes, 1) * 2), bucket_bytes), 1)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (*peers, m) stack as (N, m) rows, peer p = pod * dp + d."""
    return x.reshape(-1, x.shape[-1])


def _block(cfg, m: int) -> int:
    """The quantization block of an m-element bucket (0 = one block)."""
    return cfg.block if cfg.block > 0 else m


def _shared_scale(x: torch.Tensor, cfg, world=None) -> torch.Tensor:
    """Per-block max-abs scale shared by all peers: each peer's
    ``compute_scale``, then the max over the peer dimension and, for
    peers as processes, the JAX ``lax.pmax`` over the sync axes.  x:
    (N, m) -> (nblocks,)."""
    spec = QuantSpec(bits=cfg.bits, block=cfg.block)
    scale = torch.stack([compute_scale(row, spec) for row in x]).amax(dim=0)
    return scale if world is None else world.pmax(scale, cfg.axes)


def _encode(x: torch.Tensor, scale: torch.Tensor, cfg) -> torch.Tensor:
    """(N, m) f32 bucket -> offset-binary B-bit codes (N, nblocks, block),
    zero-block safe: a block whose shared scale is at the f32-tiny floor
    (all zero on every peer) gets the zero code.  The pam4 encode kernel
    on the card, its plain version on the CPU."""
    return pam4_quantize_encode(x, scale, cfg.bits, _block(cfg, x.shape[1]))


def _decode(u: torch.Tensor, scale: torch.Tensor, cfg, n: int, size: int,
            base: torch.Tensor | None = None) -> torch.Tensor:
    """Codes or code sums (rows, nblocks, block) -> f32 (rows, size):
    Q(mean) over n peers, dequantized with the zero-block safe scale
    (n = 1 decodes a peer's own codes); with ``base``, ``base`` minus
    that, rounded once (the error-feedback term, as XLA fuses it)."""
    return pam4_decode_dequantize(u.reshape(u.shape[0], -1), scale,
                                  cfg.bits, n, size, base)


def _finish(total: torch.Tensor, n: int, u: torch.Tensor, x: torch.Tensor,
            scale: torch.Tensor, cfg):
    """Epilogue of both optinc paths (JAX: the tail of ``_quantized_sync``
    and ``_finish_photonic``): Q(mean) over n of the code sums ``total``
    (width,) dequantized, and, with error feedback on, each peer's input
    minus its locally quantized gradient; both through the pam4 decode
    kernel.  The photonic path passes its averaged codes with n = 1."""
    m = x.shape[1]
    out = _decode(total.reshape(1, -1), scale, cfg, n, m)[0]
    if not cfg.error_feedback:
        return out, None
    return out, _decode(u, scale, cfg, 1, m, base=x)


def _injection(cfg, key):
    """The Table-II row to inject for this bucket, or None (no
    ``error_layers``, no key, or a row without errors)."""
    if not cfg.error_layers or key is None:
        return None
    spec = error_model.TABLE_II[tuple(cfg.error_layers)]
    return spec if spec.values else None


def _inject(u_avg: torch.Tensor, spec, cfg, key, shards: int):
    """Table-II errors on the averaged codes (L,), drawn from the raw
    bucket key: one draw of ceil(L / shards) codes applied to each of
    ``shards`` consecutive shards (the JAX devices' reduce-scattered
    shards, each injected with the same key; 1 = the whole vector)."""
    width = u_avg.numel()
    s = -(-width // shards)
    hit, which = error_model.draws(key, (s,), spec, u_avg.device)
    padded = F.pad(u_avg.reshape(-1), (0, s * shards - width))
    out = error_model.inject_with(padded.view(shards, s), hit, which, spec,
                                  cfg.bits)
    return out.reshape(-1)[:width]


def _quantized_sync(x: torch.Tensor, cfg, key=None):
    """Shared quantize -> integer sum -> Q(mean) -> dequantize path of
    optinc and the behavioral cascade over the (N, m) rows ``x``.
    Without injection Q(mean) and the dequantize are one decode launch;
    with it, Q(mean) of the code sums in tensor ops (the decode kernel's
    arithmetic: a product with f32(1/N), rounded half to even), the
    injection on N shards, then the decode at n = 1."""
    n = x.shape[0]
    scale = _shared_scale(x, cfg)
    u = _encode(x, scale, cfg)
    total = u.sum(dim=0, dtype=torch.int32)
    spec = _injection(cfg, key)
    if spec is None:
        return _finish(total, n, u, x, scale, cfg)
    u_avg = torch.round(total.float() * f32_reciprocal(n)).to(torch.int32)
    return _finish(_inject(u_avg, spec, cfg, key, n), 1, u, x, scale, cfg)


def lanes16(bits: int, n: int) -> bool:
    """JAX's reduce-scatter dtype choice: int16 when the n-way sum of
    B-bit codes fits, (2^B - 2) n < 2^15 (16-bit lanes here)."""
    return (2 ** bits - 2) * n < 2 ** 15


def _scatter_plan(cfg, world) -> list:
    """JAX's ordered (axis, 16-bit lanes) reduce-scatter schedule: optinc
    every sync axis in the type of the N-way sum; the cascade its
    within-pod 'data' level in the type of the dp-way sum, then the
    other axes in int32."""
    if cfg.mode == "cascade" and len(cfg.axes) > 1:
        lvl1 = cfg.axes[-1]
        return ([(lvl1, lanes16(cfg.bits, world.axis_size(lvl1)))]
                + [(ax, False) for ax in cfg.axes[:-1]])
    n = world.axis_size(cfg.axes)
    return [(ax, lanes16(cfg.bits, n)) for ax in cfg.axes]


def _quantized_sync_ranks(x: torch.Tensor, cfg, key, world):
    """``_quantized_sync`` for peers as processes, in JAX's shard-local
    structure; x is this rank's (1, m) row, the result the (m,) average
    and this rank's (1, m) residual row."""
    n = world.axis_size(cfg.axes)
    scale = _shared_scale(x, cfg, world)
    u = _encode(x, scale, cfg)
    width = u[0].numel()
    s = -(-width // n)                    # JAX's shard: ceil(L / N) codes
    parts = F.pad(u.reshape(-1), (0, s * n - width))
    plan = _scatter_plan(cfg, world)
    for ax, lanes in plan:
        parts = world.psum_scatter(parts, ax, lanes)
    u_avg = torch.round(parts.float() * f32_reciprocal(n)).to(torch.int32)
    spec = _injection(cfg, key)
    if spec is not None:
        hit, which = error_model.draws(key, (s,), spec, u_avg.device)
        u_avg = error_model.inject_with(u_avg, hit, which, spec, cfg.bits)
    coded = u_avg.to(torch.uint8 if cfg.bits <= 8 else torch.uint16)
    for ax, _ in reversed(plan):
        coded = world.all_gather(coded, ax)
    return _finish(coded[:width].to(torch.int32), 1, u, x, scale, cfg)


def _finish_photonic(u_avg, u, x, scale, cfg, key):
    """Epilogue of both photonic paths: Table-II injection over the whole
    averaged code vector (raw bucket key), then ``_finish`` at n = 1."""
    spec = _injection(cfg, key)
    if spec is not None:
        u_avg = _inject(u_avg, spec, cfg, key, 1)
    return _finish(u_avg, 1, u, x, scale, cfg)


def _noise_key(key, noise):
    """The level key seeding PhaseNoise, folded off the bucket's sync
    key (as JAX folds it, leaving the raw key to Table-II injection).  A
    noisy run without a step key would train noise-free in silence, so
    that combination raises."""
    if noise is None:
        return None
    if key is None:
        raise ValueError(
            "PhotonicsConfig noise (theta_drift_std/shot_noise_std > 0) "
            "needs a per-step sync key; pass key= to sync_flat or "
            "sync_gradients")
    return prng.fold_in(key, 1)


def _photonic_sync(x: torch.Tensor, cfg, key=None, world=None):
    """The hardware-in-the-loop OptINC path (fidelity 'onn' or 'mesh'):
    the B-bit codes of the N peers run one ``photonics.pipeline`` level
    instead of the integer Q(mean), with the PhaseNoise model when the
    config sets a noise std (peers as processes: the level's unit P sums
    over the sync axes)."""
    n = x.shape[0] if world is None else world.axis_size(cfg.axes)
    ph = cfg.photonics
    module = ph_runtime.get_module(ph, cfg.bits, n, x.device)
    scale = _shared_scale(x, cfg, world)
    u = _encode(x, scale, cfg)
    noise = ph_pipeline.PhaseNoise.from_config(ph)
    pipe = ph_pipeline.level_pipeline(module, cfg.bits,
                                      fidelity=ph.fidelity,
                                      mesh_backend=ph.mesh_backend,
                                      noise=noise, blk_b=ph.blk_b,
                                      world=world, axes=cfg.axes)
    u_avg = pipe.run(u.reshape(x.shape[0], -1),
                     key=_noise_key(key, noise)).data
    return _finish_photonic(u_avg, u, x, scale, cfg, key)


def _photonic_cascade_sync(x: torch.Tensor, cfg, key=None, world=None):
    """The two-level carry cascade through the emulated fabric, x:
    (pods, dp, m).  Level 0 reduces each pod's dp peers and emits the
    eq.-10 decimal part off its analog readout (ONN resolved for n1 =
    dp); the pods' code stacks sit side by side, (dp, pods * L), so one
    pipeline run (one launch a layer) serves every pod.  Level 1 reduces
    over the pods with the carry merged into the least-significant unit-P
    group and quantizes once (ONN resolved for all N, Preprocess over
    the pods).  The noise keys are ``split(fold_in(key, 1))``.  Peers as
    processes: x is this rank's (1, m) row, level 0 sums over 'data'
    and level 1 over 'pod', every pod with the same level-0 key."""
    if num_symbols(cfg.bits) != 1:
        # the carry rides the least-significant unit-P group, which stays
        # on the ONN's training grid only for one symbol per value
        raise ValueError(
            f"the photonic cascade (fidelity={cfg.photonics.fidelity!r}) "
            f"supports bits <= 2 (one PAM4 symbol per value, where the "
            f"eq.-10 carry is exactly representable on the unit-P grid); "
            f"got bits={cfg.bits}.  Use fidelity='behavioral' for wider "
            f"bit widths")
    if world is None:
        pods, dp = x.shape[:2]
    else:
        pods = world.axis_size(cfg.axes[:-1])
        dp = world.axis_size(cfg.axes[-1])
    ph = cfg.photonics
    mod0 = ph_runtime.get_module(ph, cfg.bits, dp, x.device)
    mod1 = ph_runtime.get_module(ph, cfg.bits, pods * dp, x.device)
    flat = _rows(x)
    scale = _shared_scale(flat, cfg, world)
    u = _encode(flat, scale, cfg)
    width = u[0].numel()
    noise = ph_pipeline.PhaseNoise.from_config(ph)
    nk = _noise_key(key, noise)
    nk0 = nk1 = None
    if nk is not None:
        nk0, nk1 = prng.split(nk)
    kw = dict(fidelity=ph.fidelity, mesh_backend=ph.mesh_backend,
              noise=noise, blk_b=ph.blk_b, world=world)
    p0 = ph_pipeline.level_pipeline(mod0, cfg.bits, emit_carry=True,
                                    axes=cfg.axes[-1:], **kw)
    p1 = ph_pipeline.level_pipeline(mod1, cfg.bits, axes=cfg.axes[:-1], **kw)
    if world is None:       # every pod's level 0 in one run, side by side
        u0 = u.reshape(pods, dp, width).transpose(0, 1).reshape(dp, -1)
    else:                   # this rank's codes, summed over its pod
        u0 = u.reshape(1, width)
    here = u0.shape[1] // width           # the pods this level 0 holds
    lvl0 = p0.run(u0, key=nk0)
    u_avg = p1.run(lvl0.data.reshape(here, width), key=nk1,
                   frac=lvl0.frac.reshape(here, width)).data
    return _finish_photonic(u_avg, u, flat, scale, cfg, key)


class PsumBackend:
    """Exact all-reduce mean over the peers (reference)."""
    name = "psum"

    def sync(self, x, cfg, key=None, world=None):
        x = _rows(x)
        if world is not None:
            n = world.axis_size(cfg.axes)
            return world.psum(x[0], cfg.axes) / n, None
        return x.sum(dim=0) / x.shape[0], None

    def bytes_on_wire(self, nbytes: float, n: int, bits: int) -> float:
        # ring-equivalent all-reduce: RS + AG, (N-1)/N of the payload each
        return 2.0 * (n - 1) / max(n, 1) * nbytes

    def time_on_wire(self, nbytes: float, n: int, bits: int,
                     overlap: bool = False,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> float:
        # electrical all-reduce: nothing to reconfigure, the wire stays
        # saturated either way; 2(N-1) serial rounds pay a hop each
        return (self.bytes_on_wire(nbytes, n, bits) / WIRE_BYTES_PER_S
                + 2.0 * (n - 1) * HOP_LATENCY_S)


def _ring_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 of x (n, ..., m) in a ring all-reduce's f32
    order (JAX ``_ring_allreduce_flat``, paper Fig. 1): pad m to n
    chunks; chunk c is accumulated from peer c forward around the ring,
    ((x_c + x_{c+1}) + x_{c+2}) + ... + x_{c-1}, one indexed add a round
    over all chunks at once; the all-gather only copies."""
    n, m = x.shape[0], x.shape[-1]
    if n == 1:
        return x[0]
    c = -(-m // n)
    xp = F.pad(x, (0, n * c - m)).reshape(n, -1, n, c)  # peer, rest, chunk
    chunk = torch.arange(n, device=x.device)
    acc = xp[chunk, :, chunk]                           # (chunk, rest, c)
    for r in range(1, n):
        acc = acc + xp[(chunk + r) % n, :, chunk]
    return acc.transpose(0, 1).reshape(*x.shape[1:-1], n * c)[..., :m]


def _ring_allreduce_ranks(x: torch.Tensor, world, ax: str) -> torch.Tensor:
    """JAX's ``_ring_allreduce_flat`` of this rank's (m,) bucket over
    axis ``ax``: a reduce-scatter, then an all-gather, each (k - 1)
    ``ppermute`` rounds to the next rank of the axis; chunk c is summed
    from rank c forward, as ``_ring_sum`` sums it."""
    k = world.axis_size(ax)
    if k == 1:
        return x
    i, m = world.axis_index(ax), x.shape[0]
    chunks = F.pad(x, (0, (-m) % k)).reshape(k, -1).clone()
    for r in range(k - 1):
        chunks[(i - r - 1) % k] += world.ppermute(chunks[(i - r) % k], ax)
    for r in range(k - 1):
        chunks[(i - r) % k] = world.ppermute(chunks[(i + 1 - r) % k], ax)
    return chunks.reshape(-1)[:m]


class RingBackend:
    """Ring all-reduce, the paper's baseline (2(N-1)/N blow-up): one
    ring a sync axis, 'pod' before 'data', then the product with
    f32(1/N)."""
    name = "ring"

    def sync(self, x, cfg, key=None, world=None):
        if world is not None:
            out = x.reshape(-1)
            for ax in cfg.axes:
                out = _ring_allreduce_ranks(out, world, ax)
            return out * f32_reciprocal(world.axis_size(cfg.axes)), None
        n = math.prod(x.shape[:-1])
        out = x
        while out.ndim > 1:
            out = _ring_sum(out)
        return out * f32_reciprocal(n), None

    def bytes_on_wire(self, nbytes: float, n: int, bits: int) -> float:
        return 2.0 * (n - 1) / max(n, 1) * nbytes

    time_on_wire = PsumBackend.time_on_wire  # same electrical wire model


class OptincBackend:
    """Quantize -> in-network sum -> Q(mean) -> dequantize; at fidelity
    'behavioral' Q(mean) in the integer domain, at 'onn' or 'mesh'
    through the ONN (the module docstring has the steps)."""
    name = "optinc"

    def sync(self, x, cfg, key=None, world=None):
        """One bucket (*peers, elems), or this rank's (1, elems) row of
        peers as processes (``world``); ``key`` is the bucket's sync key,
        which the PhaseNoise model (folded) and Table-II injection (raw)
        draw from."""
        x = _rows(x)
        if cfg.photonics.fidelity != "behavioral":
            return _photonic_sync(x, cfg, key, world)
        if world is not None:
            return _quantized_sync_ranks(x, cfg, key, world)
        return _quantized_sync(x, cfg, key)

    def bytes_on_wire(self, nbytes: float, n: int, bits: int) -> float:
        # one send of the B-bit codes into the optical fabric per server
        return (nbytes / 2.0) * bits / 8.0

    def time_on_wire(self, nbytes: float, n: int, bits: int,
                     overlap: bool = False,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> float:
        # one reduction circuit per bucket: program the mesh, stream the
        # codes through at line rate; streaming hides every
        # reconfiguration after the first behind the previous transfer
        t = self.bytes_on_wire(nbytes, n, bits) / WIRE_BYTES_PER_S
        nb = _n_buckets(nbytes, bucket_bytes)
        if not overlap:
            return nb * MESH_RECONFIG_S + t
        t_bucket = t / nb
        return (MESH_RECONFIG_S + t
                + max(0.0, MESH_RECONFIG_S - t_bucket) * (nb - 1))


class CascadeBackend:
    """Two-level carry cascade (paper III-C eq. 10) over (pods, dp, m):
    the last axis is the within-pod level-1 OptINC group, the first the
    cross-pod level-2 fabric.  Behavioral: the exact integer partial sums
    carried between levels and one quantization, which equals optinc's
    Q(mean) over all N peers (eq. 8).  'onn' | 'mesh': both levels
    through the emulated fabric (``_photonic_cascade_sync``), bit-exact
    against behavioral on a 100%-accurate ONN.  One sync axis: optinc."""
    name = "cascade"

    def sync(self, x, cfg, key=None, world=None):
        if (x.ndim if world is None else len(cfg.axes) + 1) == 2:
            # N2 == 1 (one pod): level 2 has nothing to merge, so the
            # eq.-10 result is the one-level optinc average
            return OptincBackend().sync(x, cfg, key, world)
        if world is None and x.ndim != 3:
            raise ValueError(
                f"cascade sync needs (pods, dp, elems) peers, got "
                f"{tuple(x.shape)}; run with a (pod, data) mesh")
        if cfg.photonics.fidelity != "behavioral":
            return _photonic_cascade_sync(x, cfg, key, world)
        if world is not None:
            return _quantized_sync_ranks(x, cfg, key, world)
        return _quantized_sync(_rows(x), cfg, key)

    def bytes_on_wire(self, nbytes: float, n: int, bits: int,
                      n1: int | None = None) -> float:
        # per-server uplink (B bits/elem) + its share of the level-1 ->
        # level-2 link carrying B + 2 ceil(log4 N1) bits/elem; n1 is the
        # level-1 group (default: the paper's balanced sqrt(N) split)
        if n1 is None:
            n1 = max(int(round(n ** 0.5)), 1)
        if n1 >= n:
            # one pod: no carry link, one-level optinc's wire cost
            return OptincBackend().bytes_on_wire(nbytes, n, bits)
        elems = nbytes / 2.0
        uplink = elems * bits / 8.0
        carry = elems * (bits + 2 * extra_symbols(n1)) / 8.0 / n1
        return uplink + carry

    def time_on_wire(self, nbytes: float, n: int, bits: int,
                     overlap: bool = False,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     n1: int | None = None) -> float:
        # two reconfigurable circuits a bucket (the pod mesh and the
        # carry mesh): serial without overlap, a 2-stage pipeline with it
        # (after the first bucket only the bottleneck stage is exposed)
        if n1 is None:
            n1 = max(int(round(n ** 0.5)), 1)
        if n1 >= n:
            return OptincBackend().time_on_wire(
                nbytes, n, bits, overlap=overlap, bucket_bytes=bucket_bytes)
        elems = nbytes / 2.0
        t0 = elems * bits / 8.0 / WIRE_BYTES_PER_S
        t1 = (elems * (bits + 2 * extra_symbols(n1)) / 8.0 / n1
              / WIRE_BYTES_PER_S)
        nb = _n_buckets(nbytes, bucket_bytes)
        r = MESH_RECONFIG_S
        if not overlap:
            return nb * 2 * r + t0 + t1
        fill = 2 * r + t0 / nb + t1 / nb      # first bucket through both
        drain = max(max(t0 / nb, r), max(t1 / nb, r))
        return fill + (nb - 1) * drain


register_backend("psum", PsumBackend())
register_backend("ring", RingBackend())
register_backend("optinc", OptincBackend())
register_backend("cascade", CascadeBackend())
