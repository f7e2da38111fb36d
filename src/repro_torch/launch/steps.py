"""The data-parallel training step over peers stacked on one card
(counterpart of ``repro.launch.steps.make_train_step``, replicated
group only: tensor parallelism 1, no FSDP).

The JAX step runs inside shard_map, one program per device of the
('pod', 'data') axes.  Here the N = pods * dp peers are a loop on one
device: peer p = pod * dp + d takes rows [p B/N, (p+1) B/N) of the
global batch, as shard_map splits it over the (pod, data) mesh, and
computes its loss and gradients on them; the gradients go into one
(N, total) f32 stack (leaves in ``jax.tree.flatten`` order), which
``collectives.engine.sync_flat`` synchronizes bucket by bucket.  The
synced gradients are clipped by their global norm and applied by AdamW.
The reported loss is the mean over peers, as ``lax.pmean`` gives.

With ``SyncConfig.overlap`` the peers still run one after another, so a
bucket is complete only once the LAST peer has written its leaves:
per-leaf gradient hooks on the last peer's backward write each leaf
into the stack as the backward produces it and report it to an
``engine.BucketStream``, which launches every bucket whose leaves are
all written (on the card on a side CUDA stream, overlapping the rest of
that backward).  The result is the barrier path's, bit for bit.

Peers as processes (``world``, ``launch.distributed``): rank r is peer
r and takes rows [r B/N, (r+1) B/N) of the global batch, as the stacked
loop's peer r does; its (1, total) gradient row goes through the
backends' collectives, and with overlap its own backward's hooks feed
the stream.  The loss is the mean of the ranks' losses gathered in
rank order (the stacked sum, bit for bit; an all-reduce would sum in
NCCL's order).  Clipping and AdamW run on the synced gradients, which
every rank holds alike, so the parameters stay replicated.
"""
from __future__ import annotations

import torch

from ..collectives.bucketizer import make_layout, unbucketize
from ..collectives.engine import (BucketStream, SyncConfig, residual_size,
                                  sync_flat)
from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update, clip_by_global_norm
from ..tree import leaves, unflatten


def init_sync_state(cfg: ModelConfig, peers: int, sync: SyncConfig,
                    device="cuda") -> dict:
    """Zero error-feedback residuals, {"rep": (peers, n_params)} f32, or
    {} when feedback is off.  (The JAX state also has an "fsdp" group,
    which is always empty without FSDP.)"""
    if not sync.error_feedback:
        return {}
    n = residual_size([torch.empty(s, device="meta")
                       for s in leaves(lm.param_shapes(cfg))])
    return {"rep": torch.zeros((peers, n), dtype=torch.float32,
                               device=device)}


def grad_readiness(global_indices, n_leaves: int) -> tuple:
    """Per-leaf gradient emission ranks for a leaf group (lower = that
    gradient leaves the backward earlier): the backward runs the network
    back to front, so leaf i of the forward-ordered tree is ready at
    rank n_leaves - 1 - i (``bucketizer.launch_order``'s model)."""
    return tuple(n_leaves - 1 - i for i in global_indices)


def _grads_from_hooks(loss, train, row: torch.Tensor, leaf_ready):
    """The backward of ``loss`` with a hook on every leaf that writes its
    gradient into ``row`` (the leaves concatenated) as soon as the
    backward produces it and then calls ``leaf_ready(i)``."""
    handles, off = [], 0
    for i, p in enumerate(train):
        def hook(g, i=i, off=off):
            row[off:off + g.numel()] = g.reshape(-1)
            leaf_ready(i)
        handles.append(p.register_hook(hook))
        off += p.numel()
    try:
        torch.autograd.grad(loss, train)
    finally:
        for h in handles:
            h.remove()


def peer_grad_stack(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    peers: int, total: int, leaf_ready=None,
                    out: torch.Tensor | None = None):
    """Each peer's loss and gradient on its rows of the global batch:
    peer p takes rows [p B/N, (p+1) B/N), as shard_map splits them.
    Returns (losses (peers,) f32, gradients (peers, total) f32, leaves in
    sorted-key order), the gradients in ``out`` when given.  With
    ``leaf_ready`` the last peer's leaves are written from gradient hooks
    during its backward, each reported by ``leaf_ready(leaf index)``."""
    if tokens.shape[0] % peers:
        raise ValueError(f"global batch {tokens.shape[0]} is not "
                         f"divisible by {peers} peers")
    per = tokens.shape[0] // peers
    train = [p.detach().requires_grad_() for p in leaves(params)]
    tparams = unflatten(params, train)
    flat = out if out is not None else torch.empty(
        (peers, total), dtype=torch.float32, device=tokens.device)
    losses = []
    for i in range(peers):
        loss, _ = lm.loss_fn(cfg, tparams,
                             {"tokens": tokens[i * per:(i + 1) * per]})
        if leaf_ready is not None and i == peers - 1:
            _grads_from_hooks(loss, train, flat[i], leaf_ready)
        else:
            off = 0
            for g in torch.autograd.grad(loss, train):
                flat[i, off:off + g.numel()] = g.reshape(-1)
                off += g.numel()
        losses.append(loss.detach())
    return torch.stack(losses), flat


def make_train_step(cfg: ModelConfig, peers: int, sync: SyncConfig,
                    opt: AdamWConfig, device="cuda", pods: int = 1,
                    world=None):
    """Returns ``step(params, opt_state, sync_state, tokens, key=None) ->
    (params, opt_state, sync_state, metrics)`` over ``peers`` = pods * dp
    peers; tokens: (B, t + 1) on ``device`` with B a multiple of
    ``peers``; ``key``: the step's sync key (``prng``; the PhotonicsConfig
    noise and Table-II injection draw from it); metrics: {"loss",
    "grad_norm"}.  With ``sync.overlap`` each call leaves its
    ``BucketStream`` in ``step.last_stream`` (launch order, ``early``).
    ``world``: this process is one peer of ``peers`` processes (its
    sync state the (1, total) residual row, tokens the global batch)."""
    shapes = leaves(lm.param_shapes(cfg))
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in shapes],
                         sync.bucket_bytes)
    local = peers if world is None else 1

    def grads_and_sync(params, tokens, residual, key):
        if world is not None:
            per = tokens.shape[0] // peers
            tokens = tokens[world.rank * per:(world.rank + 1) * per]
        if not sync.overlap:
            losses, flat = peer_grad_stack(cfg, params, tokens, local,
                                           layout.total)
            return losses, flat, *sync_flat(flat, layout.bounds, sync,
                                            residual, key, pods, world)
        flat = torch.empty((local, layout.total), dtype=torch.float32,
                           device=tokens.device)
        stream = BucketStream(layout, sync, flat, residual, key, pods, world)
        step.last_stream = stream
        losses, _ = peer_grad_stack(cfg, params, tokens, local, layout.total,
                                    stream.leaf_ready, flat)
        return losses, flat, *stream.finish()

    def step(params, opt_state, sync_state, tokens, key=None):
        if tokens.shape[0] % peers:
            raise ValueError(f"global batch {tokens.shape[0]} is not "
                             f"divisible by {peers} peers")
        losses, flat, synced, residual = grads_and_sync(
            params, tokens.to(device), sync_state.get("rep"), key)
        if world is not None:
            losses = world.gather_rows(losses)
        if sync.error_feedback:
            sync_state = {"rep": residual if residual is not None
                          else torch.zeros_like(flat)}
        grads = unflatten(params, unbucketize([synced], layout))
        grads, gnorm = clip_by_global_norm(grads, opt.clip_norm)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, sync_state, {"loss": losses.sum() / peers,
                                               "grad_norm": gnorm}

    step.last_stream = None
    return step
