"""Layer primitives of the dense transformer (counterpart of
``repro.models.layers``) at tensor parallelism 1.

The JAX module runs inside shard_map and closes each row-parallel
projection with ``lax.psum`` over 'model'; at tp=1 those collectives are
identities and are left out here, as are the FSDP gathers.

Attention keeps the JAX names: ``blocked_attention`` is the flash
kernel with its gradient (``kernels.attention.FlashAttention``: the CUDA
forward and backward kernels for CUDA tensors, their plain versions for
CPU tensors), and
``decode_attention``/``paged_gather``, the gather decode math that only
the paged kernel's plain version uses, are defined in ``kernels.ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.attention import FlashAttention
from ..kernels.ref import NEG_INF, decode_attention, paged_gather

__all__ = ["NEG_INF", "rmsnorm", "rope", "embed_lookup", "lm_loss",
           "blocked_attention", "decode_attention", "swiglu_mlp",
           "paged_update_cache", "paged_gather"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., t, h, hd), pos: (t,) or (b, t)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (..., t, hd/2)
    ang = ang[..., None, :]                                # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows for token ids (the whole vocabulary at tp=1)."""
    return F.embedding(ids, emb)


def lm_loss(x: torch.Tensor, head: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the whole vocabulary (tp=1): x (b, t, d), head
    (d, V), targets (b, t).  Returns the mean NLL, f32.  The JAX version
    scans sequence chunks of 1024 under ``jax.checkpoint`` to bound the
    live logits; that memory device is not ported (one chunk here)."""
    logits = (x @ head).float()                        # (b, t, V)
    m = logits.detach().amax(dim=-1)                  # stability shift only
    lse = torch.log(torch.exp(logits - m[..., None]).sum(dim=-1)) + m
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def blocked_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention with a gradient, through the flash kernels.
    q: (b, h, sq, hd), k/v: (b, hkv, skv, hd), last dims contiguous."""
    return FlashAttention.apply(q, k, v)


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU MLP.  w_gate/w_up: (d, ff), w_down: (ff, d)."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# -------------------------- paged KV cache ---------------------------

def paged_update_cache(pool: torch.Tensor, new: torch.Tensor, page_ids,
                       offsets) -> torch.Tensor:
    """Write one decode step's K or V for a packed slot batch into a paged
    pool, IN PLACE (the JAX version returns a new pool and relies on
    buffer donation to avoid the copy).  pool: (P, hkv, page, hd);
    new: (b, hkv, 1, hd); page_ids/offsets: (b,) each slot's target page
    and in-page offset.  Inactive slot rows point at the reserved null
    page 0, whose contents are never read as valid."""
    pool[page_ids, :, offsets, :] = new[:, :, 0, :].to(pool.dtype)
    return pool
