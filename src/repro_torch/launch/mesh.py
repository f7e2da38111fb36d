"""The data-parallel mesh axes of the port (counterpart of
``repro.launch.mesh``).

JAX names the axes of its device mesh ('pod', 'data', 'model'); the
port runs tensor parallelism 1, so its peers form the ('pod', 'data')
grid, pods x dp, peer p = pod * dp + d.  The gradient sync runs over
``sync_axes(pods)``: ('pod', 'data') with a pod axis, ('data',)
without, as JAX's ``ctx.dp_axes``.  Stacked peers are one leading
tensor dimension a sync axis; peers as processes (``distributed``) are
the ranks of a ``DeviceMesh`` with these names.
"""
from __future__ import annotations

AXIS_NAMES = ("pod", "data")


def sync_axes(pods: int) -> tuple:
    """The mesh axes the gradients are averaged over."""
    return AXIS_NAMES if pods > 1 else AXIS_NAMES[1:]
