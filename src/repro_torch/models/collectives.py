"""The collectives inside the model under tensor parallelism and FSDP
(the ``lax`` calls of ``repro.models.layers`` and ``repro.models.
blocks``).

Each is an autograd function over a process mesh ``axes`` (an object
with ``sizes`` by axis name and the ``psum``, ``pmax``,
``all_gather_dim`` and ``psum_scatter_dim`` collectives of
``launch.distributed.ProcessAxes``), and its backward is JAX's
transpose of the collective under ``shard_map(..., check_vma=False)``,
not the Megatron one: ``psum_model`` (all-reduce over 'model';
backward: all-reduce of the cotangent), ``all_gather_data`` (tiled
all-gather along an axis over 'data'; backward: the reduce-scatter sum)
and ``pmax_model`` (all-reduce max of a value that takes no gradient, as
JAX's ``pmax`` of a ``stop_gradient``).  So the gradients of
model-sharded leaves are tp times the tp = 1 ones and the replicated
leaves' gradients differ between model ranks, as in the reference.
Without processes (``axes`` None) or at axis size 1 each is the
identity.
"""
from __future__ import annotations

import torch


class _PsumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return axes.psum(x, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.psum(g.contiguous(), "model"), None


class _AllGatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return axes.all_gather_dim(w, "data", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.psum_scatter_dim(g, "data", ctx.dim), None, None


def psum_model(x: torch.Tensor, axes) -> torch.Tensor:
    """JAX's ``lax.psum(x, 'model')`` with its ``check_vma=False``
    transpose: an all-reduce sum over this rank's model group, whose
    backward all-reduces the cotangent."""
    if axes is None or axes.sizes["model"] == 1:
        return x
    return _PsumModel.apply(x, axes)


def all_gather_data(w: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """JAX's ``gather_fsdp``, ``lax.all_gather(w, 'data', axis=dim,
    tiled=True)``: the FSDP shards of this rank's data group joined
    along ``dim``; the backward reduce-scatters the cotangent (a sum, in
    its dtype)."""
    if axes is None or axes.sizes["data"] == 1:
        return w
    return _AllGatherData.apply(w, axes, dim)


def pmax_model(x: torch.Tensor, axes) -> torch.Tensor:
    """JAX's ``lax.pmax`` over 'model' of a value that takes no gradient
    (the loss's stability shift): an all-reduce max of x detached."""
    x = x.detach()
    if axes is None or axes.sizes["model"] == 1:
        return x
    return axes.pmax(x, "model")
