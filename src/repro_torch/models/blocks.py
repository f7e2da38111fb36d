"""GQA self-attention blocks of the dense transformer (counterpart of
``repro.models.blocks``): the training/prefill branch of
``gqa_attention`` (differentiable: attention goes through the flash
kernels' autograd function, and nothing autograd saves is written in
place) and the paged decode step ``gqa_decode_paged``.

Under tensor parallelism each rank holds its heads: hl = h_pad / tp
query heads and kvl = kv_pad / tp KV heads (``_heads_local`` and
``_kv_local``; kv < tp replicates the KV heads, one a rank), so the
flash kernels run on the local heads, and the out-projection closes
with the psum over 'model'.  FSDP shards of wq/wk/wv/wo are gathered
where they are used."""
from __future__ import annotations

from ..kernels.paged_attention import paged_attention
from .collectives import psum_model
from .config import ModelConfig
from .layers import (NO_SHARD, ShardCtx, blocked_attention, gather_fsdp,
                     paged_update_cache, rmsnorm, rope)


def _heads_local(h: int, tp: int) -> int:
    """Query heads per shard after padding h up to a multiple of tp."""
    return max(1, -(-h // tp))


def _kv_local(kv: int, tp: int) -> int:
    """KV heads per shard (>=1; kv < tp means replication across shards)."""
    return max(1, kv // tp)


def _gqa_qkv(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
             axes=None):
    """Shared q/k/v projection + RoPE of prefill and paged decode, so
    their per-token math stays identical.  x: (b, t, d);
    pos: (t,) shared positions or (b, t) per-slot positions."""
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    wq = gather_fsdp(ctx, axes, p["wq"], 0)
    wk = gather_fsdp(ctx, axes, p["wk"], 0)
    wv = gather_fsdp(ctx, axes, p["wv"], 0)
    hl = wq.shape[-1] // cfg.hd
    kvl = wk.shape[-1] // cfg.hd
    q = (h @ wq).reshape(b, t, hl, cfg.hd)
    k = (h @ wk).reshape(b, t, kvl, cfg.hd)
    v = (h @ wv).reshape(b, t, kvl, cfg.hd)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def gqa_attention(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
                  axes=None):
    """Causal self-attention over a whole sequence batch (the training
    and prefill branch of the JAX ``gqa_attention``) on this rank's
    heads.  x: (b, t, d), pos: (t,).  Returns (out (b, t, d), psummed
    over 'model', {"k", "v": (b, kvl, t, hd)})."""
    q, k, v = _gqa_qkv(cfg, p, x, pos, ctx, axes)
    b, t, hl = q.shape[:3]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    attn = blocked_attention(q.transpose(1, 2), k, v)
    attn = attn.transpose(1, 2).reshape(b, t, hl * cfg.hd)
    out = attn @ gather_fsdp(ctx, axes, p["wo"], 1)
    return psum_model(out, axes), {"k": k, "v": v}


def gqa_decode_paged(cfg: ModelConfig, p, x, lengths, pool_kv, page_table):
    """One paged decode step of GQA self-attention over a packed slot
    batch.  x: (b, 1, d) each slot's pending token; lengths: (b,) int32
    tokens already cached per slot (the new token's position); pool_kv:
    {"k","v"} physical page pools (P, hkv, page, hd), written IN PLACE;
    page_table: (b, nb) int32 per-slot page ids.  Returns (out, pool_kv).

    Attention reads the pool in place through ``kernels.paged_attention``
    (the JAX ``decode_backend='paged'`` path): the CUDA kernel for CUDA
    tensors, its plain version (the JAX gather math) for CPU tensors."""
    ps = pool_kv["k"].shape[2]
    q, k, v = _gqa_qkv(cfg, p, x, lengths[:, None])
    q = q.transpose(1, 2)                            # (b, hl, 1, hd)
    k = k.transpose(1, 2)                            # (b, kvl, 1, hd)
    v = v.transpose(1, 2)
    lengths_l = lengths.long()
    page_ids = page_table.long().gather(1, (lengths_l // ps)[:, None])[:, 0]
    offsets = lengths_l % ps
    kp = paged_update_cache(pool_kv["k"], k, page_ids, offsets)
    vp = paged_update_cache(pool_kv["v"], v, page_ids, offsets)
    attn = paged_attention(q, kp, vp, page_table, lengths + 1)
    b, hl = q.shape[:2]
    attn = attn.transpose(1, 2).reshape(b, 1, hl * cfg.hd)
    return attn @ p["wo"], {"k": kp, "v": vp}
