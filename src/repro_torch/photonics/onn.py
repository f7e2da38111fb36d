"""The ONN f_theta (counterpart of ``repro.photonics.onn``): an MLP with
ReLU activations (paper IV) whose inputs are the preprocessed signals
A_k scaled to [0, 1] and whose outputs are M analog values that the
transceivers quantize to the nearest PAM4 level.

Every dense layer runs through the ``onn_layer`` kernel
(``kernels.onn_layer``: the CUDA kernel for CUDA tensors, the plain
version for CPU ones), with d = 1 and ReLU on all layers but the last.
The JAX package computes the same layers in plain jnp inside ``jit``,
where XLA compiles the input scaling ``a / in_scale`` into a product
with the f32 reciprocal; ``apply`` computes that compiled form.

``project_approx`` applies the matrix approximation to the selected
layers; ``map_to_hardware`` programs every layer onto MZI meshes (numpy,
as in the JAX package) and ``apply_hardware`` is the numpy f64 oracle of
that mapping.  The fast mesh forward pass is ``mesh.apply_hardware``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.onn_layer import onn_layer
from . import approx as approx_mod
from . import area as area_mod
from . import mzi as mzi_mod
from .encoding import f32_reciprocal, preprocess_group_size


@dataclasses.dataclass(frozen=True)
class ONNConfig:
    structure: tuple  # e.g. (4, 64, 128, 256, 128, 64, 4)
    approx_layers: tuple = ()  # 1-based layer indices to approximate
    bits: int = 8              # B: gradient bit width
    n_servers: int = 4         # N
    k_inputs: int = 4          # K (ONN input size after the P unit)

    @property
    def in_scale(self) -> float:
        """A_k ranges over [0, 4^g - 1]; normalize to [0, 1]."""
        g = preprocess_group_size(self.bits, self.k_inputs)
        return float(4 ** g - 1)

    @property
    def out_scale(self) -> float:
        return 3.0  # PAM4 symbol levels {0,1,2,3}


def init_params(cfg: ONNConfig, seed: int = 0, device="cuda") -> list:
    """He-normal weights and zero biases, the JAX ``init_params`` recipe,
    drawn from one CPU ``torch.Generator`` layer by layer, so they do not
    depend on the device; they are not the numbers ``jax.random`` draws
    (carry JAX weights across with ``params_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for m, n in area_mod.layer_dims(list(cfg.structure)):
        w = torch.randn((m, n), generator=gen) * math.sqrt(2.0 / n)
        params.append({"w": w.to(device),
                       "b": torch.zeros((m,), device=device)})
    return params


def params_from_jax(params, device="cuda") -> list:
    """The JAX package's ONN parameters as f32 tensors on ``device``: a
    list of dense layers {"w", "b"} and, from ``training.init_params`` in
    cayley mode, constrained layers {"p", "d", "b", "shape"} (numpy or
    anything ``np.asarray`` takes; "shape" stays a tuple)."""
    return [{k: tuple(v) if k == "shape" else
             torch.from_numpy(np.array(v, np.float32)).to(device)
             for k, v in layer.items()} for layer in params]


def apply(params, a: torch.Tensor, cfg: ONNConfig) -> torch.Tensor:
    """Forward pass.  a: (..., K) raw preprocessed inputs -> (..., M)
    analog outputs in symbol units (approximately {0..3}); one
    ``onn_layer`` launch per layer."""
    lead = a.shape[:-1]
    x = a.float().reshape(-1, a.shape[-1]) * f32_reciprocal(cfg.in_scale)
    last = len(params) - 1
    for i, layer in enumerate(params):
        x = onn_layer(x, layer["w"], torch.ones_like(layer["b"]),
                      layer["b"], relu=i < last)
    return (x * cfg.out_scale).reshape(lead + (x.shape[-1],))


@dataclasses.dataclass(frozen=True)
class Transceiver:
    """Receiver-side transceiver: quantize the ONN's analog outputs to the
    nearest PAM4 symbol level (the paper's ADC/decision stage), round
    half to even like ``jnp.round``."""
    levels: int = 3  # PAM4: symbols {0, 1, 2, 3}

    def readout(self, outputs: torch.Tensor) -> torch.Tensor:
        return torch.round(outputs).clamp(0, self.levels).to(torch.int32)


def readout(outputs: torch.Tensor) -> torch.Tensor:
    """Transceiver model: quantize analog outputs to the nearest PAM4
    level."""
    return Transceiver().readout(outputs)


def area_ratio(cfg: ONNConfig) -> float:
    return area_mod.area_ratio(list(cfg.structure), set(cfg.approx_layers))


def project_approx(params, cfg: ONNConfig) -> list:
    """Apply the matrix approximation to the selected layers (projection
    step of the hardware-aware training, paper III-B)."""
    out = []
    for idx, layer in enumerate(params, start=1):
        if idx in cfg.approx_layers:
            out.append({"w": approx_mod.approx_matrix(layer["w"]),
                        "b": layer["b"]})
        else:
            out.append(layer)
    return out


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


# ---------------- hardware mapping (MZI programming) ----------------

def map_to_hardware(params, cfg: ONNConfig) -> list:
    """Program every layer onto MZI meshes. Approximated layers use the
    Sigma_a U_a form (one mesh + diag); others use full SVD (two meshes).
    Returns a list of per-layer hardware programs (numpy)."""
    hw = []
    for idx, layer in enumerate(params, start=1):
        w = np.asarray(_np(layer["w"]), np.float64)
        m, n = w.shape
        if idx in cfg.approx_layers:
            s = approx_mod.block_size(m, n)
            blocks = []
            if m >= n:
                parts = w.reshape(m // s, s, n)
            else:
                parts = w.reshape(m, n // s, s).transpose(1, 0, 2)
            for ws in parts:
                d, ua = approx_mod.approx_block_factors(ws)
                blocks.append({"d": d, "u": mzi_mod.givens_decompose(ua)})
            hw.append({"kind": "approx", "blocks": blocks, "shape": (m, n),
                       "b": _np(layer["b"])})
        else:
            pu, s, pv = mzi_mod.program_matrix_svd(w)
            hw.append({"kind": "svd", "u": pu, "sigma": s, "v": pv,
                       "shape": (m, n), "b": _np(layer["b"])})
    return hw


def apply_hardware(hw, a: np.ndarray, cfg: ONNConfig) -> np.ndarray:
    """Numpy forward pass through the programmed MZI meshes: the f64
    oracle that the mapping preserves the trained function."""
    x = np.asarray(a, np.float64) / cfg.in_scale
    for li, layer in enumerate(hw):
        m, n = layer["shape"]
        if layer["kind"] == "svd":
            y = mzi_mod.apply_programmed_svd(layer["u"], layer["sigma"],
                                             layer["v"], x.T).T
        elif m >= n:
            y = np.concatenate([(mzi_mod.reconstruct(p["u"]) @ x.T).T * p["d"]
                                for p in layer["blocks"]], axis=-1)
        else:
            s = min(m, n)
            xs = x.reshape(x.shape[:-1] + (n // s, s))
            y = 0.0
            for j, p in enumerate(layer["blocks"]):
                y = y + (mzi_mod.reconstruct(p["u"]) @ xs[..., j, :].T).T \
                    * p["d"]
        y = y + layer["b"]
        if li < len(hw) - 1:
            y = np.maximum(y, 0.0)
        x = y
    return x * cfg.out_scale
