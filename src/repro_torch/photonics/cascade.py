"""Cascading OptINC topology (paper III-C, Fig. 5, eq. 8-10); a copy of
``repro.photonics.cascade``, which is plain numpy.

Two levels of OptINCs support N^2 servers.  Naive cascading quantizes
twice (eq. 9) and drops the level-1 decimal parts; the paper's fix (eq.
10) carries the decimal part d as one extra, higher-resolution PAM4
output symbol from level 1 into level 2, making the cascade exact with
respect to eq. 8.  The runtime form is ``collectives.backends``'
cascade backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def expected(u: np.ndarray) -> np.ndarray:
    """Eq. (8): single-shot quantized average over all N^2 servers.
    u: (N, N, ...) integer gradients."""
    n2 = u.shape[0] * u.shape[1]
    return np.round(u.reshape(-1, *u.shape[2:]).sum(0) / n2).astype(np.int64)


def basic_cascade(u: np.ndarray) -> np.ndarray:
    """Eq. (9): two naive quantized averages (loses the decimal parts)."""
    n1 = u.shape[1]
    lvl1 = np.round(u.sum(1) / n1)
    n0 = u.shape[0]
    return np.round(lvl1.sum(0) / n0).astype(np.int64)


def carry_cascade(u: np.ndarray, n_extra_levels: int = 1) -> np.ndarray:
    """Eq. (10): level-1 OptINCs emit the averaged gradient at resolution
    1/N (integer part + decimal part d merged into the last PAM4 symbol);
    level 2 averages the exact values and quantizes once."""
    n1 = u.shape[1]
    lvl1_exact = u.sum(1) / n1          # integer + decimal part d, res 1/N
    n0 = u.shape[0]
    return np.round(lvl1_exact.sum(0) / n0).astype(np.int64)


def extra_symbols(n_servers: int) -> int:
    """How many extra PAM4 symbols carry the decimal part at resolution
    1/N: ceil(log4(N))."""
    s = 0
    r = 1
    while r < n_servers:
        r *= 4
        s += 1
    return s


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """The scaled scenario of paper IV: scenario-1 OptINCs (B=8, N=4)
    cascaded 5x in two levels to support 16 servers.  The ONN structure
    is widened by inserting one extra matrix after the first layer and
    one before the last (both with matrix approximation)."""
    bits: int = 8
    n_per_optinc: int = 4

    def expanded_structure(self, base: tuple) -> tuple:
        # insert 64x64 matrices after the first and before the last layer
        return ((base[0], base[1], base[1]) + base[2:-2]
                + (base[-2], base[-2], base[-1]))

    def expanded_approx_layers(self, base_structure: tuple) -> tuple:
        """Base scenario-1 approximates all layers; the two inserted
        64x64 matrices are approximated too (paper IV)."""
        n_weights = len(self.expanded_structure(base_structure)) - 1
        return tuple(range(1, n_weights + 1))


def hardware_overhead(base_structure: tuple, base_approx: tuple) -> float:
    """MZI overhead of the expanded cascade ONN over the base ONN (paper:
    ~10.5%)."""
    from . import area as area_mod
    cc = CascadeConfig()
    exp_struct = list(cc.expanded_structure(tuple(base_structure)))
    exp_approx = set(cc.expanded_approx_layers(tuple(base_structure)))
    base = area_mod.area_mzis(list(base_structure), set(base_approx))
    exp = area_mod.area_mzis(exp_struct, exp_approx)
    return exp / base - 1.0
