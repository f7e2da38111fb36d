"""Matrix approximation W_s ~= Sigma_a U_a (paper eq. 4-6, Fig. 4);
counterpart of ``repro.photonics.approx``.

A rectangular weight W (m x n) is partitioned into square s x s submatrices
along its longer dimension (s = min(m, n)); each submatrix is approximated by

    W_a = Sigma_a @ U_a,   U_a = U_s V_s^T  (orthogonal Procrustes),
    d_i = argmin_d ||W_s^i - d * U_a^i||^2 = <W_s^i, U_a^i>   (U_a rows unit)

which halves the MZI count (one mesh + one diagonal column instead of two
meshes + a column).  ``block_size`` and ``approx_block_factors`` are the
numpy functions of the JAX module, copied, so hardware mapping
(``onn.map_to_hardware``) programs the same factors.  ``approx_block``,
``approx_matrix`` and ``approx_error`` run on tensors with
``torch.linalg.svd``; only ``onn.project_approx`` uses them, and an SVD
in another library agrees with JAX's to a tolerance, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def block_size(m: int, n: int) -> int:
    s = min(m, n)
    if m % s or n % s:
        raise ValueError(f"matrix {m}x{n} not partitionable into {s}x{s} blocks")
    return s


def approx_block(ws: torch.Tensor) -> torch.Tensor:
    """Sigma_a U_a approximation of one square block (eq. 4-6)."""
    u, _, vt = torch.linalg.svd(ws, full_matrices=False)
    ua = u @ vt                      # orthogonal Procrustes solution
    d = torch.sum(ws * ua, dim=1)    # least-squares row scales (rows unit norm)
    return d[:, None] * ua


def approx_block_factors(ws: np.ndarray):
    """Numpy variant returning (d, U_a) for hardware mapping."""
    u, _, vt = np.linalg.svd(ws, full_matrices=False)
    ua = u @ vt
    d = np.sum(ws * ua, axis=1)
    return d, ua


def approx_matrix(w: torch.Tensor) -> torch.Tensor:
    """Partition (horizontally or vertically, Fig. 4) and approximate every
    block."""
    m, n = w.shape
    s = block_size(m, n)
    if m == n:
        return approx_block(w)
    if m > n:   # tall: horizontal cuts -> stack of (s x n=s) blocks
        blocks = w.reshape(m // s, s, n)
        return torch.stack([approx_block(b) for b in blocks]).reshape(m, n)
    # wide: vertical cuts
    blocks = w.reshape(m, n // s, s).transpose(0, 1)
    out = torch.stack([approx_block(b) for b in blocks])
    return out.transpose(0, 1).reshape(m, n)


def approx_error(w: torch.Tensor) -> float:
    """Relative Frobenius error of the approximation (diagnostic)."""
    wa = approx_matrix(w)
    return float(torch.linalg.norm(w - wa)
                 / torch.linalg.norm(w).clamp_min(1e-30))
