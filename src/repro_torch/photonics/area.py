"""MZI area-cost model (paper II-B, Table I/II area columns); a copy of
``repro.photonics.area``, which is pure Python.

Full SVD mapping of an M x N matrix:  (M(M+1) + N(N-1)) / 2 MZIs.
Approximated s x s block (eq. 4):     s(s+1)/2 MZIs
                                      (s(s-1)/2 for U_a + s diagonal).
"""
from __future__ import annotations


def mzi_count_svd(m: int, n: int) -> int:
    return (m * (m + 1) + n * (n - 1)) // 2


def mzi_count_approx(m: int, n: int) -> int:
    s = min(m, n)
    assert m % s == 0 and n % s == 0
    nblocks = (m // s) * (n // s)
    return nblocks * (s * (s + 1) // 2)


def layer_dims(structure: list[int]) -> list[tuple[int, int]]:
    """[4, 64, 128, ..., 4] -> [(64,4), (128,64), ...] (out x in)."""
    return [(structure[i + 1], structure[i]) for i in range(len(structure) - 1)]


def area_mzis(structure: list[int], approx_layers: set[int] | None = None) -> int:
    """Total MZI count. ``approx_layers`` uses the paper's 1-based layer
    indices (layer i = weight between neurons i and i+1)."""
    approx_layers = approx_layers or set()
    total = 0
    for idx, (m, n) in enumerate(layer_dims(structure), start=1):
        if idx in approx_layers:
            total += mzi_count_approx(m, n)
        else:
            total += mzi_count_svd(m, n)
    return total


def area_ratio(structure: list[int], approx_layers: set[int]) -> float:
    """Area of the approximated ONN / area of the full-SVD ONN (Table I col 5)."""
    return area_mzis(structure, approx_layers) / area_mzis(structure, set())
