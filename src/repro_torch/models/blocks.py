"""Attention and MoE blocks (counterpart of ``repro.models.blocks``):
the training/prefill branch of ``gqa_attention`` (self-attention, or
whisper's cross-attention over given K/V, causal or not; differentiable:
attention goes through the flash kernels' autograd function, and
nothing autograd saves is written in place), the paged decode step
``gqa_decode_paged``, the training branch of deepseek-v3's
``mla_attention`` (the flash kernels with a V head dim of their own)
and ``moe_block`` (top-k routed experts with expert-side top-C token
selection, expert-parallel over 'model', and the shared experts).

Under tensor parallelism each rank holds its heads: hl = h_pad / tp
query heads and kvl = kv_pad / tp KV heads (``_heads_local`` and
``_kv_local``; kv < tp replicates the KV heads, one a rank), so the
flash kernels run on the local heads, and the out-projection closes
with the psum over 'model'.  FSDP shards of wq/wk/wv/wo are gathered
where they are used."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.paged_attention import paged_attention
from .collectives import all_gather_model, psum_model
from .config import ModelConfig
from .layers import (NO_SHARD, ShardCtx, blocked_attention, gather_fsdp,
                     paged_update_cache, rmsnorm, rope, tp_index)


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
    pos: (t,) shared positions or (b, t) per-slot positions, or None for
    no RoPE (JAX's ``pos is not None`` test)."""
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
    if pos is not None:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def gqa_attention(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
                  axes=None, kv_ext=None, causal: bool = True):
    """Self-attention over a whole sequence batch (the training and
    prefill branch of the JAX ``gqa_attention``) on this rank's heads,
    causal unless ``causal=False``.  x: (b, t, d), pos: (t,).  With
    ``kv_ext`` = (k, v), each (b, kvl, te, hd), cross-attention (the
    whisper decoder's): q = rmsnorm(x) @ wq with no RoPE, over the given
    K/V.  Returns (out (b, t, d), psummed over 'model', {"k", "v": (b,
    kvl, t, hd)}, or None with ``kv_ext``)."""
    if kv_ext is None:
        q, k, v = _gqa_qkv(cfg, p, x, pos, ctx, axes)
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
        cache = {"k": k, "v": v}
    else:
        h = rmsnorm(x, p["norm"])
        wq = gather_fsdp(ctx, axes, p["wq"], 0)
        q = (h @ wq).reshape(*h.shape[:2], wq.shape[-1] // cfg.hd, cfg.hd)
        (k, v), cache = kv_ext, None
    b, t, hl = q.shape[:3]
    attn = blocked_attention(q.transpose(1, 2), k, v, causal)
    attn = attn.transpose(1, 2).reshape(b, t, hl * cfg.hd)
    out = attn @ gather_fsdp(ctx, axes, p["wo"], 1)
    return psum_model(out, axes), cache


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


# ========================= MLA (deepseek-v3) ==========================

def mla_attention(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
                  axes=None):
    """Multi-head Latent Attention, the training/prefill branch of the
    JAX ``mla_attention``: per-head K/V materialised from the compressed
    kv, the rope part of K one head shared by every local head, and
    attention with a QK head dim hd + rd and a V head dim hd through the
    flash kernels (scale (hd + rd)^-0.5).  Returns (out (b, t, d),
    psummed over 'model', None): the compressed decode cache is not
    ported (the JAX engine serves no MoE model)."""
    hd, rd, kvr = cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    hl = p["wq_b"].shape[-1] // (hd + rd)
    cq = rmsnorm(h @ gather_fsdp(ctx, axes, p["wq_a"], 0), p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(b, t, hl, hd + rd)
    q_rope = rope(q[..., hd:], pos, cfg.rope_theta)
    ckv_full = h @ gather_fsdp(ctx, axes, p["wkv_a"], 0)   # (b, t, kvr + rd)
    ckv = rmsnorm(ckv_full[..., :kvr], p["kv_norm"])
    k_rope = rope(ckv_full[..., None, kvr:], pos, cfg.rope_theta)
    kv = (ckv @ p["wkv_b"]).reshape(b, t, hl, 2 * hd)
    k = torch.cat([kv[..., :hd], k_rope.expand(b, t, hl, rd)], dim=-1)
    qf = torch.cat([q[..., :hd], q_rope], dim=-1)
    attn = blocked_attention(qf.transpose(1, 2), k.transpose(1, 2),
                             kv[..., hd:].transpose(1, 2))
    attn = attn.transpose(1, 2).reshape(b, t, hl * hd)
    return psum_model(attn @ gather_fsdp(ctx, axes, p["wo"], 1), axes), None


# ================================ MoE =================================

def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values, descending,
    and their indices, the lower index first among equal values (a
    stable sort; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, n_tok: int) -> int:
    """Tokens an expert takes (JAX's Python float arithmetic)."""
    cap = int(n_tok * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return min(cap, n_tok)


def moe_block(cfg: ModelConfig, p, x, ctx: ShardCtx = NO_SHARD, axes=None):
    """Top-k routed experts, expert-parallel over 'model' with
    expert-side top-C token selection (no all-to-all: activations are
    replicated over 'model', so each rank runs its El local experts on
    the tokens it selects), plus the shared experts where the layer has
    them (a TP-sharded SwiGLU without its own norm).  p: router (d, El),
    w_gate/w_up (El, d, ffe), w_down (El, ffe, d) local shards (FSDP
    shards gathered here).  Returns (out (b, t, d), psummed over
    'model', the switch aux loss E sum(mean(gates) mean(full > 0)))."""
    h = rmsnorm(x, p["norm"])
    b, t, d = h.shape
    xt = h.reshape(b * t, d)
    n_tok = b * t
    logits = all_gather_model((xt @ p["router"]).float(), axes, 1)  # (T, E)
    ex = torch.exp(logits - logits.detach().amax(dim=-1, keepdim=True))
    gates = ex / ex.sum(dim=-1, keepdim=True)
    top_g, top_e = top_k(gates, cfg.top_k)
    top_g = top_g / top_g.sum(dim=-1, keepdim=True)
    full = torch.zeros_like(gates).scatter(1, top_e, top_g)
    el = p["router"].shape[-1]
    e_lo = tp_index(ctx, axes) * el
    local_gates = full[:, e_lo:e_lo + el]                       # (T, El)
    cap = capacity(cfg, n_tok)
    g_sel, idx = top_k(local_gates.T, cap)                      # (El, C)
    flat_idx = idx.reshape(-1)
    xe = xt[flat_idx].reshape(el, cap, d)
    gh = torch.bmm(xe, gather_fsdp(ctx, axes, p["w_gate"], 1))
    uh = torch.bmm(xe, gather_fsdp(ctx, axes, p["w_up"], 1))
    hh = F.silu(gh.float()).to(x.dtype) * uh
    ye = torch.bmm(hh, gather_fsdp(ctx, axes, p["w_down"], 2))
    ye = ye * g_sel[..., None].to(ye.dtype)
    out = torch.zeros((n_tok, d), dtype=ye.dtype, device=ye.device
                      ).index_add(0, flat_idx, ye.reshape(-1, d))
    if "sh_gate" in p:
        g = xt @ gather_fsdp(ctx, axes, p["sh_gate"], 0)
        u = xt @ gather_fsdp(ctx, axes, p["sh_up"], 0)
        out = out + (F.silu(g.float()).to(x.dtype) * u) @ gather_fsdp(
            ctx, axes, p["sh_down"], 1)
    out = psum_model(out.reshape(b, t, d), axes)
    me = gates.mean(dim=0)
    ce = (full > 0).float().mean(dim=0)
    return out, cfg.n_experts * (me * ce).sum()
