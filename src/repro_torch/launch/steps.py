"""The data-parallel training step over peers stacked on one card
(counterpart of ``repro.launch.steps.make_train_step``, replicated
group only: tensor parallelism 1, no FSDP).

The JAX step runs inside shard_map, one program per device of the
'data' axis.  Here the N peers are a loop on one device: peer i takes
rows [i B/N, (i+1) B/N) of the global batch, as shard_map splits it,
and computes its loss and gradients on them; the gradients go into one
(N, total) f32 stack (leaves in ``jax.tree.flatten`` order), which
``collectives.engine.sync_flat`` synchronizes bucket by bucket.  The
synced gradients are clipped by their global norm and applied by AdamW.
The reported loss is the mean over peers, as ``lax.pmean`` gives.
"""
from __future__ import annotations

import torch

from ..collectives.bucketizer import make_layout, unbucketize
from ..collectives.engine import SyncConfig, residual_size, sync_flat
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


def peer_grad_stack(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    peers: int, total: int):
    """Each peer's loss and gradient on its rows of the global batch:
    peer i takes rows [i B/N, (i+1) B/N), as shard_map splits them.
    Returns (losses (peers,) f32, gradients (peers, total) f32, leaves in
    sorted-key order)."""
    if tokens.shape[0] % peers:
        raise ValueError(f"global batch {tokens.shape[0]} is not "
                         f"divisible by {peers} peers")
    per = tokens.shape[0] // peers
    train = [p.detach().requires_grad_() for p in leaves(params)]
    tparams = unflatten(params, train)
    flat = torch.empty((peers, total), dtype=torch.float32,
                       device=tokens.device)
    losses = []
    for i in range(peers):
        loss, _ = lm.loss_fn(cfg, tparams,
                             {"tokens": tokens[i * per:(i + 1) * per]})
        off = 0
        for g in torch.autograd.grad(loss, train):
            flat[i, off:off + g.numel()] = g.reshape(-1)
            off += g.numel()
        losses.append(loss.detach())
    return torch.stack(losses), flat


def make_train_step(cfg: ModelConfig, peers: int, sync: SyncConfig,
                    opt: AdamWConfig, device="cuda"):
    """Returns ``step(params, opt_state, sync_state, tokens, key=None) ->
    (params, opt_state, sync_state, metrics)``; tokens: (B, t + 1) on
    ``device`` with B a multiple of ``peers``; ``key``: the step's sync
    key (``prng``; the PhotonicsConfig noise needs one); metrics:
    {"loss", "grad_norm"}."""
    shapes = leaves(lm.param_shapes(cfg))
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in shapes],
                         sync.bucket_bytes)

    def step(params, opt_state, sync_state, tokens, key=None):
        losses, flat = peer_grad_stack(cfg, params, tokens.to(device), peers,
                                       layout.total)
        synced, residual = sync_flat(flat, layout.bounds, sync,
                                     sync_state.get("rep"), key)
        if sync.error_feedback:
            sync_state = {"rep": residual if residual is not None
                          else torch.zeros_like(flat)}
        grads = unflatten(params, unbucketize([synced], layout))
        grads, gnorm = clip_by_global_norm(grads, opt.clip_norm)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, sync_state, {"loss": losses.sum() / peers,
                                               "grad_norm": gnorm}

    return step
