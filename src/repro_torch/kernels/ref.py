"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

Each kernel wrapper runs its plain version for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against it on the card.  Both
compute in float32 whatever the input dtype, like the TPU kernels.

``decode_attention`` and ``paged_gather`` are the JAX package's
``models.layers`` functions of those names (the gather decode path);
they live here because the paged kernel's plain version is built from
them, and ``models.layers`` re-exports them under their JAX home.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30   # finite: exp(NEG_INF - m) == 0.0 for any finite m


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, straight softmax in f32.  q: (b, h, sq, hd),
    k/v: (b, hkv, skv, hd) with h a multiple of hkv (kv head = q head //
    rep, no repeat).  The masks are those of
    ``repro.models.layers.blocked_attention``: a query row r sees key
    columns c <= r + (skv - sq).  Returns (b, h, sq, hd) in q.dtype."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, sq, hd) * hd ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float())
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    s = s.masked_fill(cols > rows + (skv - sq), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """One-token attention over a contiguous KV view.  q: (b, h, 1, hd);
    k_cache/v_cache: (b, hkv, S, hd); pos: number of valid cache entries,
    an int or a (b,) tensor of per-slot counts."""
    b, h, _, hd = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, hd) * hd ** -0.5
    s = torch.einsum("bgrd,bgkd->bgrk", qf, k_cache.float())
    idx = torch.arange(s_len, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    if pos.ndim:
        valid = (idx[None, :] < pos[:, None])[:, None, None, :]
    else:
        valid = (idx < pos)[None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrk,bgkd->bgrd", p, v_cache.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, 1, hd).to(q.dtype)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's pages as a contiguous (b, hkv, nb*page, hd) KV view.
    pool: (P, hkv, page, hd); page_table: (b, nb) page ids in
    logical-block order.  Entries beyond a slot's allocation hit the null
    page and are masked out by decode_attention's validity test."""
    b, nb = page_table.shape
    _, hkv, ps, hd = pool.shape
    pages = pool[page_table.long()]                   # (b, nb, hkv, ps, hd)
    return pages.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * ps, hd)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged pool the gather way: each slot's
    pages copied contiguous (``paged_gather``), then ``decode_attention``
    with per-slot lengths.  Shapes as ``paged_attention.paged_attention``."""
    return decode_attention(q, paged_gather(k_pool, page_table),
                            paged_gather(v_pool, page_table), lengths)
