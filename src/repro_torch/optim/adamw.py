"""AdamW with global-norm clipping (counterpart of
``repro.optim.adamw``), on nested parameter dicts.

The arithmetic is the JAX package's, in its order and in f32: moments
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, bias correction
by ``1 - b^t`` computed in f32, decoupled weight decay on matrices only
(ndim >= 2).  ``torch.optim.AdamW`` orders these operations differently,
so it is not used.  The updates run under ``torch.no_grad`` and return
new tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # JAX's bf16-moment option; the port keeps f32 moments only
    # (RunSpec.validate refuses "bfloat16", adamw_init raises on it)
    moment_dtype: str = "float32"


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """f32 moments (the JAX ``moment_dtype`` option, bf16 moments, is not
    ported) and step 0."""
    if cfg.moment_dtype != "float32":
        raise NotImplementedError(
            f"AdamWConfig.moment_dtype={cfg.moment_dtype!r}: bf16 AdamW "
            f"moments are not ported yet")
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, axes=(), world=None):
    """Scale every gradient by min(1, max_norm / ||g||), the norm taken
    over all leaves in f32; the squared norm is psummed over the mesh
    ``axes`` of ``world`` (the process mesh) so sharded leaves count
    whole.  The JAX step passes ('model',) only: under FSDP each data
    rank clips by its own norm, and replicated leaves count once a model
    rank.  Returns (grads, norm)."""
    sq = sum((g.float() * g.float()).sum() for g in leaves(grads))
    if world is not None and axes:
        sq = world.psum(sq.reshape(1), axes)[0]
    norm = torch.sqrt(sq)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * factor).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 lr_scale: float = 1.0):
    t = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    tf = t.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=tf.device), tf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=tf.device), tf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if p.ndim >= 2:      # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m32, v32

    new = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"]))]
    return (unflatten(params, [n[0] for n in new]),
            {"m": unflatten(params, [n[1] for n in new]),
             "v": unflatten(params, [n[2] for n in new]), "step": t})
