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

Not ported yet (ROADMAP.md): ``project_approx`` (needs ``approx.py``)
and ``map_to_hardware``/``apply_hardware`` (need ``mzi.py``), with the
mesh fidelity and ONN training.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.onn_layer import onn_layer
from . import area as area_mod
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
    """The JAX package's ONN parameters (a list of {"w", "b"}, numpy or
    anything ``np.asarray`` takes) as f32 tensors on ``device``."""
    return [{k: torch.from_numpy(np.array(layer[k], np.float32)).to(device)
             for k in ("w", "b")} for layer in params]


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
