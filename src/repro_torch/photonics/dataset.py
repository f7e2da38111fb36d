"""ONN training datasets (paper III-A and III-C; counterpart of
``repro.photonics.dataset``).

With the preprocessing unit P, each ONN input A_k takes values
{0, 1/N, 2/N, ..., 4^g - 1}, i.e. V = N (4^g - 1) + 1 distinct values, so
the full dataset has V^K samples (vs 2^(M N) without P).  Targets are the
PAM4 symbols of Q(sum_k A_k 4^(g (K - k))) (the exact behavioural
transfer function, eq. 3).

The arrays are numpy, computed as the JAX module computes them, so they
are bit-equal to its; ``server_side_dataset`` runs the port's own
encoding functions on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import encoding as enc
from .encoding import num_symbols, preprocess_group_size
from .onn import ONNConfig


def grid_values(cfg: ONNConfig) -> np.ndarray:
    """All V distinct values one preprocessed input A_k can take."""
    g = preprocess_group_size(cfg.bits, cfg.k_inputs)
    v = cfg.n_servers * (4 ** g - 1) + 1
    return np.arange(v, dtype=np.float64) / cfg.n_servers


def dataset_size(cfg: ONNConfig) -> int:
    return len(grid_values(cfg)) ** cfg.k_inputs


def _targets_from_inputs(a: np.ndarray, cfg: ONNConfig) -> np.ndarray:
    g = preprocess_group_size(cfg.bits, cfg.k_inputs)
    k = cfg.k_inputs
    w = (4.0 ** g) ** np.arange(k - 1, -1, -1)
    total = np.round(a @ w).astype(np.int64)
    m = num_symbols(cfg.bits)
    shifts = 4 ** np.arange(m - 1, -1, -1, dtype=np.int64)
    return ((total[:, None] // shifts) % 4).astype(np.int32)


def full_dataset(cfg: ONNConfig):
    """Enumerate the complete (V^K, K) input grid + PAM4 targets."""
    vals = grid_values(cfg)
    k = cfg.k_inputs
    grids = np.meshgrid(*([vals] * k), indexing="ij")
    a = np.stack([g.reshape(-1) for g in grids], axis=-1)
    return a.astype(np.float32), _targets_from_inputs(a, cfg)


def sampled_dataset(cfg: ONNConfig, rng: np.random.Generator, count: int):
    """Uniform sample of the grid, for the scenarios whose full grid (up
    to 13.8M samples) is too large to train on."""
    vals = grid_values(cfg)
    idx = rng.integers(0, len(vals), size=(count, cfg.k_inputs))
    a = vals[idx]
    return a.astype(np.float32), _targets_from_inputs(a, cfg)


def server_side_dataset(cfg: ONNConfig, rng: np.random.Generator,
                        count: int):
    """End-to-end check data: random B-bit server gradients -> PAM4
    encode -> P unit -> (A, target symbols of Q(mean))."""
    u = rng.integers(0, 2 ** cfg.bits - 1, size=(cfg.n_servers, count),
                     dtype=np.int64)
    sym = enc.pam4_encode(torch.from_numpy(u).to(torch.int32), cfg.bits)
    a = enc.preprocess(sym, cfg.bits, cfg.k_inputs)
    tgt = enc.expected_avg_symbols(sym, cfg.bits)
    return a.numpy().astype(np.float32), tgt.numpy().astype(np.int32)
