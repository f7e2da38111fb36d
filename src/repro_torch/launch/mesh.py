"""The mesh axes of the port (counterpart of ``repro.launch.mesh``).

JAX names the axes of its device mesh ('pod', 'data', 'model').  The
data-parallel peers form the ('pod', 'data') grid, pods x dp, peer p =
pod * dp + d; each peer is tp ranks of the 'model' axis.  The ranks of
peers as processes (``distributed``) follow JAX's device order, 'model'
fastest: rank = (pod * dp + d) * tp + m (``rank_of``/``coords_of``).
The gradient sync runs over ``sync_axes(pods)``: ('pod', 'data') with a
pod axis, ('data',) without, as JAX's ``ctx.dp_axes``.  Stacked peers
are one leading tensor dimension a sync axis.
"""
from __future__ import annotations

AXIS_NAMES = ("pod", "data", "model")


def sync_axes(pods: int) -> tuple:
    """The mesh axes the gradients are averaged over."""
    return ("pod", "data") if pods > 1 else ("data",)


def rank_of(pod: int, d: int, m: int, dp: int, tp: int) -> int:
    """The rank (JAX's device index) of mesh coordinates (pod, d, m)."""
    return (pod * dp + d) * tp + m


def coords_of(rank: int, dp: int, tp: int) -> tuple:
    """(pod, d, m) of a rank, the inverse of ``rank_of``."""
    return rank // (dp * tp), rank // tp % dp, rank % tp
