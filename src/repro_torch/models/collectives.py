"""The collectives inside the model under tensor parallelism and FSDP
(the ``lax`` calls of ``repro.models.layers`` and ``repro.models.
blocks``).

Each is an autograd function over a process mesh ``axes`` (an object
with ``sizes`` by axis name and the ``psum``, ``pmax``,
``all_gather_dim`` and ``psum_scatter_dim`` collectives of
``launch.distributed.ProcessAxes``), and its backward is JAX's
transpose of the collective under ``shard_map(..., check_vma=False)``,
not the Megatron one: ``psum_model`` (all-reduce over 'model';
backward: all-reduce of the cotangent), ``all_gather_data`` and
``all_gather_model`` (tiled all-gather along an axis over 'data' or
'model'; backward: the reduce-scatter sum of the cotangent) and
``pmax_model`` (all-reduce max of a value that takes no gradient, as
JAX's ``pmax`` of a ``stop_gradient``).  ``all_gather_model`` joins the
MoE router's logits, which every model rank then uses whole: its
reduce-scatter sums the tp ranks' equal cotangents, so the router's
gradient through it is tp times the tp-1 one, as in the reference
(``jax.grad`` of ``all_gather(x @ w_local)`` in such a shard_map on 2
CPU devices gives 2x the one-device gradient; JAX 0.9.0).  So the gradients of
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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axes, ax, dim):
        ctx.axes, ctx.ax, ctx.dim = axes, ax, dim
        return axes.all_gather_dim(w, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.axes.psum_scatter_dim(g, ctx.ax, ctx.dim), None, None,
                None)


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
    return _AllGather.apply(w, axes, "data", dim)


def all_gather_model(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """JAX's ``lax.all_gather(x, 'model', axis=dim, tiled=True)``: the
    model ranks' x joined along ``dim`` in axis order; the backward
    reduce-scatters the cotangent over 'model' (a sum, in its dtype)."""
    if axes is None or axes.sizes["model"] == 1:
        return x
    return _AllGather.apply(x, axes, "model", dim)


def pmax_model(x: torch.Tensor, axes) -> torch.Tensor:
    """JAX's ``lax.pmax`` over 'model' of a value that takes no gradient
    (the loss's stability shift): an all-reduce max of x detached."""
    x = x.detach()
    if axes is None or axes.sizes["model"] == 1:
        return x
    return axes.pmax(x, "model")
