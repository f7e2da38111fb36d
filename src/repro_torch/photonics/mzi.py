"""MZI hardware model: interleaving arrays, Givens decomposition, programming
(the port's copy of ``repro.photonics.mzi``, numpy like the original, so
the same weights give the same Givens programs rotation for rotation).

An M x M real orthogonal matrix is realized by M(M-1)/2 MZIs (paper Fig. 2,
the interleaving/Clements arrangement). Each MZI acting on waveguides (i, j)
implements a 2x2 rotation parameterized by its phase shifters; the real
restriction of the unitary group that the mesh generates is exactly the set
of Givens rotations, so programming the mesh == Givens decomposition.

The diagonal Sigma of an SVD (or the Sigma_a of the paper's approximation)
is realized by one column of M MZIs used as attenuators.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MZIProgram:
    """Phase program for one orthogonal matrix on an M-port mesh."""
    dim: int
    # list of (i, j, theta): rotation in the (i, j) plane
    rotations: list
    # output sign flips (absorbed into the diagonal column / output phases)
    signs: np.ndarray

    @property
    def num_mzis(self) -> int:
        return self.dim * (self.dim - 1) // 2


def givens_decompose(o: np.ndarray, tol: float = 1e-9) -> MZIProgram:
    """Decompose real orthogonal ``o`` into M(M-1)/2 Givens rotations.

    o = diag(signs) @ prod(R(i,j,theta))  (product applied right-to-left)
    """
    o = np.asarray(o, dtype=np.float64)
    m = o.shape[0]
    assert o.shape == (m, m)
    if not np.allclose(o @ o.T, np.eye(m), atol=1e-6):
        raise ValueError("matrix is not orthogonal")
    work = o.copy()
    rotations = []
    # zero out sub-diagonal entries column by column (QR with Givens);
    # G @ work only touches rows (row-1, row), so update just that pair —
    # O(m) per rotation instead of an m x m matmul (matters when
    # programming the 256-port meshes of the paper's larger scenarios)
    for col in range(m - 1):
        for row in range(m - 1, col, -1):
            a, b = work[row - 1, col], work[row, col]
            if abs(b) < tol:
                continue
            theta = np.arctan2(b, a)
            c, s = np.cos(theta), np.sin(theta)
            hi, lo = work[row - 1].copy(), work[row]
            work[row - 1] = c * hi + s * lo
            work[row] = -s * hi + c * lo
            rotations.append((row - 1, row, float(theta)))
    signs = np.sign(np.diag(work))
    signs[signs == 0] = 1.0
    if not np.allclose(np.diag(signs) @ work, np.eye(m), atol=1e-6):
        raise ValueError("Givens elimination failed to reach identity")
    # o = (prod G_k)^{-1} diag(signs) => o = G_1^T ... G_K^T diag(signs)
    return MZIProgram(dim=m, rotations=rotations, signs=signs)


def reconstruct(program: MZIProgram) -> np.ndarray:
    """Rebuild the orthogonal matrix from the MZI phase program."""
    m = program.dim
    # elimination gave: G_K ... G_1 @ o = diag(signs)
    #   =>  o = G_1^T ... G_K^T @ diag(signs)
    acc = np.diag(program.signs.astype(np.float64))
    for (i, j, theta) in reversed(program.rotations):
        c, s = np.cos(theta), np.sin(theta)
        g = np.eye(m)
        g[i, i] = c
        g[i, j] = s
        g[j, i] = -s
        g[j, j] = c
        acc = g.T @ acc
    return acc


def program_matrix_svd(w: np.ndarray):
    """Program an arbitrary real matrix W = U S V^T onto two meshes + one
    diagonal column (paper eq. 1). Returns (prog_u, sigma, prog_v)."""
    u, s, vt = np.linalg.svd(w)
    return givens_decompose(u), s, givens_decompose(vt.T)


def apply_programmed_svd(prog_u: MZIProgram, sigma: np.ndarray,
                         prog_v: MZIProgram, x: np.ndarray) -> np.ndarray:
    """Optical forward pass through the programmed SVD mesh: W x."""
    u = reconstruct(prog_u)
    v = reconstruct(prog_v)
    m, n = u.shape[0], v.shape[0]
    s = np.zeros((m, n))
    s[: len(sigma), : len(sigma)] = np.diag(sigma)
    return u @ (s @ (v.T @ x))
