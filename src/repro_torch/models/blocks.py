"""Attention, MoE, Mamba-2 and xLSTM blocks (counterpart of
``repro.models.blocks``):
the training/prefill branch of ``gqa_attention`` (self-attention, or
whisper's cross-attention over given K/V, causal or not; differentiable:
attention goes through the flash kernels' autograd function, and
nothing autograd saves is written in place), its decode branch over a
contiguous cache ``gqa_decode``, the paged decode step
``gqa_decode_paged`` and whisper's cross-attention decode over its cross
cache ``cross_decode`` (all on the paged kernel), deepseek-v3's
``mla_attention`` (the training/prefill branch on the flash kernels with
a V head dim of their own, which also returns the int8 compressed cache,
and the absorbed decode over that cache), ``moe_block`` (top-k routed
experts with expert-side top-C token selection, expert-parallel over
'model', and the shared experts), the Mamba-2 block (``mamba2_block``
over ``ssd_chunk_scan``, or one decode step from its carried state;
plain torch ops: the JAX package has no kernel for it), and the xLSTM
family's two blocks, each with its prefill and decode branches: the
mLSTM (``mlstm_block`` over ``mlstm_chunk_scan``, the SSD's form) and
the sLSTM (``slstm_block`` over ``SLSTMScan``, its loop over t with a
backward written by hand).  qwen3's and chameleon's qk-norm runs in
``_gqa_qkv``, which training, prefill and both decodes share.

Under tensor parallelism each rank holds its heads: hl = h_pad / tp
query heads and kvl = kv_pad / tp KV heads (``_heads_local`` and
``_kv_local``; kv < tp replicates the KV heads, one a rank), so the
flash kernels run on the local heads, and the out-projection closes
with the psum over 'model'.  FSDP shards of wq/wk/wv/wo are gathered
where they are used.  The serving branches are unsharded."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.paged_attention import paged_attention
from .collectives import all_gather_model, psum_model
from .config import ModelConfig
from ..kernels.ref import fma_f32
from .layers import (NEG_INF, NO_SHARD, ShardCtx, blocked_attention,
                     gather_fsdp, paged_update_cache, rmsnorm, rope,
                     tp_index, update_cache)


def _heads_local(h: int, tp: int) -> int:
    """Query heads per shard after padding h up to a multiple of tp."""
    return max(1, -(-h // tp))


def _kv_local(kv: int, tp: int) -> int:
    """KV heads per shard (>=1; kv < tp means replication across shards)."""
    return max(1, kv // tp)


def _gqa_qkv(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
             axes=None):
    """Shared q/k/v projection + qk-norm + RoPE of prefill and paged
    decode, so their per-token math stays identical.  x: (b, t, d);
    pos: (t,) shared positions or (b, t) per-slot positions, or None for
    no RoPE (JAX's ``pos is not None`` test).  With ``cfg.qk_norm`` q and
    k are normed per head (each rank its own heads) before RoPE: JAX's
    ``_qk_headnorm`` is ``rmsnorm`` over hd (eps 1e-6, f32, cast back,
    times the (hd,) weight)."""
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
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
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
    whisper decoder's): q = rmsnorm(x) @ wq with no RoPE (normed per
    head under ``cfg.qk_norm``, as JAX does), over the given K/V.
    Returns (out (b, t, d), psummed over 'model', {"k", "v": (b, kvl,
    t, hd)}, or None with ``kv_ext``)."""
    if kv_ext is None:
        q, k, v = _gqa_qkv(cfg, p, x, pos, ctx, axes)
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
        cache = {"k": k, "v": v}
    else:
        q = _cross_q(cfg, p, x, ctx, axes)
        (k, v), cache = kv_ext, None
    b, t, hl = q.shape[:3]
    attn = blocked_attention(q.transpose(1, 2), k, v, causal)
    attn = attn.transpose(1, 2).reshape(b, t, hl * cfg.hd)
    out = attn @ gather_fsdp(ctx, axes, p["wo"], 1)
    return psum_model(out, axes), cache


def _cross_q(cfg: ModelConfig, p, x, ctx: ShardCtx = NO_SHARD, axes=None):
    """The cross-attention's queries (JAX's ``kv_ext`` branch): rmsnorm(x)
    @ wq, no RoPE, normed per head under ``cfg.qk_norm``; (b, t, hl,
    hd)."""
    h = rmsnorm(x, p["norm"])
    wq = gather_fsdp(ctx, axes, p["wq"], 0)
    q = (h @ wq).reshape(*h.shape[:2], wq.shape[-1] // cfg.hd, cfg.hd)
    return rmsnorm(q, p["q_norm"]) if cfg.qk_norm else q


def _decode_qkv(cfg: ModelConfig, p, x, pos):
    """``_gqa_qkv`` of one pending token a row at ``pos`` ((1,) shared or
    (b, 1) per slot), as (b, heads, 1, hd) each."""
    q, k, v = _gqa_qkv(cfg, p, x, pos)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _decode_out(cfg: ModelConfig, p, q, kc, vc, page_table, lengths):
    """Attention of the pending queries q (b, hl, 1, hd) over the pools
    kc/vc (P, hkv, page, hd) through ``kernels.paged_attention`` (the
    CUDA kernel for CUDA tensors, its plain version, JAX's gather math,
    for CPU tensors), then wo: (b, 1, d)."""
    attn = paged_attention(q, kc, vc, page_table, lengths)
    b, hl = q.shape[:2]
    return attn.transpose(1, 2).reshape(b, 1, hl * cfg.hd) @ p["wo"]


def _rows_as_pages(b: int, length: int, device):
    """(page table, lengths) that read a contiguous cache (b, kvl, S, hd)
    as a pool of b pages of S positions, page i row i's, every row
    ``length`` long."""
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None],
            torch.full((b,), length, dtype=torch.int32, device=device))


def gqa_decode(cfg: ModelConfig, p, x, pos: int, cache_kv,
               ctx: ShardCtx = NO_SHARD):
    """One decode step of GQA self-attention over a contiguous cache (the
    ``cache is not None`` branch of the JAX ``gqa_attention``), every
    row at position ``pos``.  x: (b, 1, d); cache_kv: {"k","v"} (b, kvl,
    S, hd), written IN PLACE at ``pos`` (``update_cache``).  The cache is
    a paged pool of b pages of S positions, page i row i's (the table
    ``arange(b)[:, None]``, the lengths pos + 1), so attention runs the
    paged kernel with no copy: the same per-token math as JAX's
    ``decode_attention``.  Returns (out (b, 1, d), cache_kv)."""
    b = x.shape[0]
    q, k, v = _decode_qkv(cfg, p, x, torch.full((1,), pos,
                                                device=x.device))
    kc = update_cache(cache_kv["k"], k, pos, ctx)
    vc = update_cache(cache_kv["v"], v, pos, ctx)
    return (_decode_out(cfg, p, q, kc, vc, *_rows_as_pages(b, pos + 1,
                                                           x.device)),
            {"k": kc, "v": vc})


def cross_decode(cfg: ModelConfig, p, x, cross_kv):
    """One decode step of the whisper decoder's cross-attention (JAX's
    ``gqa_attention`` with ``kv_ext`` at t 1): the queries of
    ``_cross_q`` over every column of the cross cache, non-causal and
    unmasked as JAX attends (``blocked_attention(causal=False)``), so
    the zero columns past the encoder's frames weigh in the softmax when
    the cache is longer than them.  x: (b, 1, d); cross_kv: {"k","v"}
    (b, kvl, S, hd), read as b pages of S positions through the paged
    kernel (the table ``arange(b)[:, None]``, every row's length S).
    Returns out (b, 1, d), before the residual."""
    kc, vc = cross_kv["k"], cross_kv["v"]
    q = _cross_q(cfg, p, x).transpose(1, 2)            # (b, hl, 1, hd)
    return _decode_out(cfg, p, q, kc, vc,
                       *_rows_as_pages(x.shape[0], kc.shape[2], x.device))


def gqa_decode_paged(cfg: ModelConfig, p, x, lengths, pool_kv, page_table):
    """One paged decode step of GQA self-attention over a packed slot
    batch.  x: (b, 1, d) each slot's pending token; lengths: (b,) int32
    tokens already cached per slot (the new token's position); pool_kv:
    {"k","v"} physical page pools (P, hkv, page, hd), written IN PLACE;
    page_table: (b, nb) int32 per-slot page ids.  Returns (out, pool_kv).

    Attention reads the pool in place through ``kernels.paged_attention``
    (the JAX ``decode_backend='paged'`` path), as ``gqa_decode`` does."""
    ps = pool_kv["k"].shape[2]
    q, k, v = _decode_qkv(cfg, p, x, lengths[:, None])
    lengths_l = lengths.long()
    page_ids = page_table.long().gather(1, (lengths_l // ps)[:, None])[:, 0]
    offsets = lengths_l % ps
    kp = paged_update_cache(pool_kv["k"], k, page_ids, offsets)
    vp = paged_update_cache(pool_kv["v"], v, page_ids, offsets)
    return (_decode_out(cfg, p, q, kp, vp, page_table, lengths + 1),
            {"k": kp, "v": vp})


# ========================= MLA (deepseek-v3) ==========================

_R127 = float(torch.tensor(1.0) / 127.0)        # f32(1/127) as a float


def quantize_ckv(ckv: torch.Tensor):
    """The int8 compressed cache of MLA (JAX's ``max|ckv| / 127.0 +
    1e-8`` per token, ``round(ckv / sc)`` as int8), in the arithmetic
    XLA compiles it to: the divide by 127 is the product with the f32
    reciprocal; in f32 the product and the + 1e-8 are one FMA; in bf16
    the product is rounded to bf16 and the bf16 epsilon added in f32,
    the f32 scale leaf keeping that sum (XLA drops the bf16 round trip),
    while ``ckv / sc`` divides by the scale rounded to bf16 and rounds
    the quotient to bf16.  round is half to even, and the cast to int8
    saturates as XLA's does (a bf16 quotient of 127.5 rounds to 128,
    which is 127, not torch's wrapped -128).  ckv: (..., kvr).  Returns
    (codes int8, scale f32 (..., 1))."""
    m = ckv.abs().amax(dim=-1, keepdim=True)
    if ckv.dtype == torch.float32:
        scale = fma_f32(m, m.new_tensor(_R127), m.new_tensor(1e-8))
    else:
        eps = torch.tensor(1e-8, dtype=ckv.dtype).float()
        scale = (m.float() * _R127).to(ckv.dtype).float() + eps
    q = (ckv.float() / scale.to(ckv.dtype).float()).to(ckv.dtype)
    return torch.round(q.float()).clamp(-128, 127).to(torch.int8), scale


def mla_attention(cfg: ModelConfig, p, x, pos, ctx: ShardCtx = NO_SHARD,
                  axes=None, cache=None, cache_pos=None):
    """Multi-head Latent Attention (deepseek-v3), JAX's
    ``mla_attention``.  Without ``cache`` the training/prefill branch:
    per-head K/V materialised from the compressed kv, the rope part of K
    one head shared by every local head, and attention with a QK head
    dim hd + rd and a V head dim hd through the flash kernels (scale (hd
    + rd)^-0.5); it also returns the compressed cache of the sequence,
    {"ckv": int8 (b, t, kvr), "scale": f32 (b, t, 1), "krope": (b, t,
    rd)} (``quantize_ckv``; training drops it).  With ``cache`` (those
    leaves at (b, S, ...)) one decode step (t 1) at ``cache_pos``, the
    absorbed form over the compressed cache: q_c = q_nope . wk, the
    token's compressed kv quantised and written IN PLACE, then in f32
    (JAX's ``astype``s) the dequantised cache, scores (q_c . c + q_rope
    . k_rope) (hd + rd)^-0.5 with the columns past ``cache_pos`` masked,
    softmax, o_c = w . c and o_c . wv; plain torch ops, as JAX's are jnp
    (no kernel).  Returns (out (b, t, d), psummed over 'model', the
    cache)."""
    hd, rd, kvr = cfg.hd, cfg.qk_rope_dim, cfg.kv_lora_rank
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    hl = p["wq_b"].shape[-1] // (hd + rd)
    cq = rmsnorm(h @ gather_fsdp(ctx, axes, p["wq_a"], 0), p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(b, t, hl, hd + rd)
    q_nope, q_rope = q[..., :hd], rope(q[..., hd:], pos, cfg.rope_theta)
    ckv_full = h @ gather_fsdp(ctx, axes, p["wkv_a"], 0)   # (b, t, kvr + rd)
    ckv = rmsnorm(ckv_full[..., :kvr], p["kv_norm"])
    k_rope = rope(ckv_full[..., None, kvr:], pos, cfg.rope_theta)
    wo = gather_fsdp(ctx, axes, p["wo"], 1)
    if cache is None:
        kv = (ckv @ p["wkv_b"]).reshape(b, t, hl, 2 * hd)
        k = torch.cat([kv[..., :hd], k_rope.expand(b, t, hl, rd)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        attn = blocked_attention(qf.transpose(1, 2), k.transpose(1, 2),
                                 kv[..., hd:].transpose(1, 2))
        attn = attn.transpose(1, 2).reshape(b, t, hl * hd)
        with torch.no_grad():                 # the codes take no gradient
            codes, scale = quantize_ckv(ckv)
        return psum_model(attn @ wo, axes), {
            "ckv": codes, "scale": scale, "krope": k_rope[:, :, 0]}
    wkv_b = p["wkv_b"].reshape(kvr, hl, 2 * hd)
    wk, wv = wkv_b[..., :hd], wkv_b[..., hd:]
    q_c = torch.einsum("bthd,rhd->bthr", q_nope, wk)      # (b, 1, hl, kvr)
    codes, scale = quantize_ckv(ckv[:, 0])
    cache["ckv"][:, cache_pos] = codes
    cache["scale"][:, cache_pos] = scale
    cache["krope"][:, cache_pos] = k_rope[:, 0, 0].to(cache["krope"].dtype)
    cdeq = cache["ckv"].float() * cache["scale"]            # (b, S, kvr)
    s = (torch.einsum("bthr,bsr->bths", q_c.float(), cdeq)
         + torch.einsum("bthd,bsd->bths", q_rope.float(),
                        cache["krope"].float())) * (hd + rd) ** -0.5
    valid = torch.arange(cdeq.shape[1], device=x.device) <= cache_pos
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o_c = torch.einsum("bths,bsr->bthr", w, cdeq)
    attn = torch.einsum("bthr,rhd->bthd", o_c, wv.float())
    attn = attn.to(x.dtype).reshape(b, t, hl * hd)
    return psum_model(attn @ wo, axes), cache


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


# =============================== Mamba-2 ===============================

def ssd_chunk_scan(xh, dt, a, bmat, cmat, chunk: int):
    """SSD chunked scan (Mamba-2; JAX's ``_ssd_chunk_scan``), the
    training and prefill form.  xh: (b, t, nh, hp); dt: (b, t, nh)
    post-softplus; a: (nh,) negative (-exp(a_log)); bmat/cmat: (b, t, N);
    all f32.  t is padded to whole chunks (dt 0 there); within a chunk
    cum is the cumsum of dt * a, and

        y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
              + (C_i . S) exp(cum_i),
        S <- S exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T

    with S the state carried from chunk to chunk (zero at first).
    Returns y (b, t, nh, hp) and the final state (b, nh, hp, N).

    The two terms a chunk adds that do not depend on S (the intra-chunk
    y and the state a chunk contributes) are computed for all chunks at
    once; only the recurrence of S loops over the chunks.  The f32 sums
    therefore run in other orders than JAX's scan: the tests hold y and
    the gradients to 1e-5 of each one's largest entry.

    A repair of the reference's gradient: JAX builds the decay as
    ``where(mask, exp(rel), 0)``.  Above the diagonal rel = cum_i - cum_j
    is positive and grows by about |a| dt a token, so exp(rel) overflows
    to inf once a chunk holds more than ~90 tokens at zamba2's init (a
    -1, dt ~ 0.97); the forward drops it, but the backward multiplies the
    inf by the zero cotangent: NaN.  Here the decay is ``exp(where(mask,
    rel, -inf))``: the forward is the same, bit for bit, and the gradient
    is JAX's wherever JAX's is finite, and 0 where JAX's is 0 * inf."""
    b, t, nh, hp = xh.shape
    n = bmat.shape[-1]
    pad = (-t) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    xc = xh.reshape(b, nc, chunk, nh, hp).permute(0, 1, 3, 2, 4)  # (b,c,h,Q,p)
    dtc = dt.reshape(b, nc, chunk, nh).transpose(2, 3)            # (b,c,h,Q)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * a[:, None], dim=-1)                  # <= 0
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()
    dec = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                                float("-inf")))                   # (b,c,h,Q,Q)
    cb = cc @ bc.transpose(-1, -2)                                # (b,c,Q,Q)
    y = (cb[:, :, None] * dec * dtc[..., None, :]) @ xc           # intra
    wj = torch.exp(cum[..., -1:] - cum) * dtc                     # (b,c,h,Q)
    s_chunk = (wj[..., None] * xc).transpose(-1, -2) @ bc[:, :, None]
    decay = torch.exp(cum[..., -1])                               # (b,c,h)
    state = torch.zeros((b, nh, hp, n), dtype=torch.float32,
                        device=xh.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * decay[:, c, :, None, None] + s_chunk[:, c]
    prev = torch.stack(before, dim=1)                             # (b,c,h,p,N)
    y = y + (cc[:, :, None] @ prev.transpose(-1, -2)) * torch.exp(
        cum)[..., None]                                           # inter
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, nh, hp)[:, :t]
    return y, state


def _causal_conv(sig: torch.Tensor, w: torch.Tensor, prev=None):
    """JAX's ``dconv``: the causal depthwise conv of sig (b, t, c) with w
    (k, c) over sig padded in front by k - 1 zero rows, or with ``prev``
    (b, k - 1, c) by the carried rows (f32: the concatenation promotes,
    so a decode step's conv runs in f32 where the prefill's runs in the
    model dtype), summed as JAX's Python ``sum`` (0 + p_0 + p_1 + ...).
    Returns (out (b, t, c), the last k - 1 rows of the padded signal)."""
    k, t = w.shape[0], sig.shape[1]
    if prev is None:
        padded = F.pad(sig, (0, 0, k - 1, 0))
    else:
        padded = torch.cat([prev, sig.to(prev.dtype)], dim=1)
    return (sum(padded[:, i:i + t] * w[i] for i in range(k)),
            padded[:, t:])


def mamba2_block(cfg: ModelConfig, p, x, state=None, chunk: int = 128):
    """The Mamba-2 (SSD) block, JAX's ``mamba2_block``, unsharded:
    in-projections of rmsnorm(x) to x (d_inner), the gate z, B|C (2N)
    and dt (nh heads); the causal depthwise conv (k 4) on the x and B|C
    paths; SiLU, dt = softplus(dt_raw + dt_bias) and a = -exp(a_log) in
    f32; the SSD scan (``ssd_chunk_scan``) over the sequence, or with
    ``state`` = {"ssm": (b, nh, hp, N), "conv_x": (b, 3, d_inner),
    "conv_bc": (b, 3, 2N)} one decode step (t 1): the convs continue
    from the carried rows, and

        S <- S exp(dt a) + dt B x^T,  y = C . S;

    the d_skip skip, the gate silu(z), cast to x's dtype, and w_out.
    jax.nn.softplus is ``logaddexp(x, 0)``, and so is this one
    (``F.softplus`` returns x above 20, which in f32 is the same value,
    but it is 2 ulp off XLA's below).  Returns (out (b, t, d), the new
    state in f32: the SSD's final state and each conv's last 3 rows of
    its input, the prefill's or the decode step's)."""
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    n = cfg.ssm_state
    nh = p["a_log"].shape[0]
    hp = p["w_x"].shape[-1] // nh
    st = state or {}
    xs, conv_x = _causal_conv(h @ p["w_x"], p["conv_x"], st.get("conv_x"))
    z = h @ p["w_z"]
    bc, conv_bc = _causal_conv(h @ p["w_bc"], p["conv_bc"],
                               st.get("conv_bc"))
    bc = F.silu(bc.float())
    xh = F.silu(xs.float()).reshape(b, t, nh, hp)
    dt = torch.logaddexp((h @ p["w_dt"]).float() + p["dt_bias"],
                         torch.zeros((), device=x.device))
    a = -torch.exp(p["a_log"].float())
    bmat, cmat = bc[..., :n], bc[..., n:]
    if state is None:
        y, ssm = ssd_chunk_scan(xh, dt, a, bmat, cmat, chunk)
    else:
        dt1, b1, x1 = dt[:, 0], bmat[:, 0], xh[:, 0]
        upd = (dt1[:, :, None, None] * b1[:, None, None, :]
               * x1[..., None])                            # (b, h, p, N)
        ssm = state["ssm"] * torch.exp(dt1 * a)[..., None, None] + upd
        y = (ssm @ cmat[:, 0, None, :, None])[..., 0][:, None]
    y = y + xh * p["d_skip"][:, None]
    y = (y.reshape(b, t, -1) * F.silu(z.float())).to(x.dtype)
    return y @ p["w_out"], {"ssm": ssm, "conv_x": conv_x.float(),
                            "conv_bc": conv_bc.float()}


# ================================ xLSTM ================================

def _max1(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 1.0)``: at a tie the gradient is halved, as
    JAX's and torch's ``maximum`` both do (``clamp_min`` passes it
    whole; the sLSTM's normaliser is 1 exactly after its first step)."""
    return torch.maximum(x, x.new_ones(()))


def mlstm_chunk_scan(q, k, v, log_f, i_raw, chunk: int):
    """The mLSTM's chunkwise-parallel scan (the ``state is None`` branch
    of JAX's ``mlstm_block``), the training and prefill form.  q (scaled
    by hp^-0.5), k, v: (b, t, nh, hp); log_f = log sigmoid(f_raw) and
    i_raw: (b, t, nh); all f32.  t is padded to whole chunks (q, k, v and
    log_f 0, i_raw -30 there); log_f is clipped to [-30, 0] and i_raw to
    [-30, 10], i = exp(i_raw); within a chunk cum is the cumsum of log_f,
    and

        h~_i = sum_{j <= i} (q_i . k_j) exp(cum_i - cum_j) i_j v_j
               + (q_i C) exp(cum_i),
        n_i  = sum_{j <= i} (q_i . k_j) exp(cum_i - cum_j) i_j
               + (q_i . n) exp(cum_i),
        y_i  = h~_i / max(|n_i|, 1),
        C <- C exp(cum_last) + sum_j exp(cum_last - cum_j) i_j k_j v_j^T,
        n <- n exp(cum_last) + sum_j exp(cum_last - cum_j) i_j k_j

    with the matrix memory C (hp, hp) and the normaliser n (hp) carried
    from chunk to chunk (zero at first).  Returns y (b, t, nh, hp) and
    the final C (b, nh, hp, hp) and n (b, nh, hp).

    As in ``ssd_chunk_scan``, the terms a chunk adds that do not depend
    on the carried state are computed for all chunks at once, and only
    the recurrence of (C, n) loops over the chunks; the f32 sums run in
    other orders than JAX's scan.

    The same repair of the reference's gradient as the SSD's: JAX builds
    the decay as ``where(mask, exp(rel), 0)``, and above the diagonal rel
    = -sum log sigmoid(f) >= 0 grows by about 0.69 a token at init
    (log sigmoid(0)), so a chunk of 128 reaches exp(88), f32's overflow;
    the forward drops the inf, the backward gives 0 * inf = NaN.  Here
    the decay is ``exp(where(mask, rel, -inf))``: the same forward, bit
    for bit, and JAX's gradient wherever JAX's is finite."""
    b, t, nh, hp = q.shape
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-30.0)
    nc = q.shape[1] // chunk

    def heads(a):                       # (b, tc, h, p) -> (b, c, h, Q, p)
        return a.reshape(b, nc, chunk, nh, hp).permute(0, 1, 3, 2, 4)

    def gates(a):                       # (b, tc, h) -> (b, c, h, Q)
        return a.reshape(b, nc, chunk, nh).transpose(2, 3)
    qc, kc, vc = heads(q), heads(k), heads(v)
    cum = torch.cumsum(gates(log_f.clamp(-30.0, 0.0)), dim=-1)   # <= 0
    ic = torch.exp(gates(i_raw.clamp(-30.0, 10.0)))
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    dec = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                                float("-inf")))                  # (b,c,h,Q,Q)
    w = (qc @ kc.transpose(-1, -2)) * dec * ic[..., None, :]
    y = w @ vc                                                   # intra
    n_q = w.sum(-1)                                              # (b,c,h,Q)
    kw = kc * (torch.exp(cum[..., -1:] - cum) * ic)[..., None]
    c_chunk = kw.transpose(-1, -2) @ vc                          # (b,c,h,p,p)
    n_chunk = kw.sum(-2)                                         # (b,c,h,p)
    decay = torch.exp(cum[..., -1])                              # (b,c,h)
    c_state = q.new_zeros((b, nh, hp, hp))
    n_state = q.new_zeros((b, nh, hp))
    c_before, n_before = [], []
    for c in range(nc):
        c_before.append(c_state)
        n_before.append(n_state)
        c_state = c_state * decay[:, c, :, None, None] + c_chunk[:, c]
        n_state = n_state * decay[:, c, :, None] + n_chunk[:, c]
    ed = torch.exp(cum)
    y = y + (qc @ torch.stack(c_before, dim=1)) * ed[..., None]  # inter
    n_q = n_q + (qc @ torch.stack(n_before, dim=1)[..., None])[..., 0] * ed
    y = y / _max1(n_q.abs())[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, nh, hp)[:, :t]
    return y, c_state, n_state


def mlstm_block(cfg: ModelConfig, p, x, state=None, chunk: int = 128):
    """The mLSTM (matrix memory) block, JAX's ``mlstm_block``, unsharded:
    rmsnorm(x) projected to q, k, v, the gate z (d_inner 2d each, nh
    heads of hp = 2d / nh) and the input and forget gates (nh each); in
    f32 q scaled by hp^-0.5, log_f = log sigmoid(f); the chunkwise scan
    (``mlstm_chunk_scan``) over the sequence, or with ``state`` = {"c":
    (b, nh, hp, hp), "n": (b, nh, hp)} one decode step (t 1):

        C <- f C + i k v^T,  n <- f n + i k,  y = q C / max(|q . n|, 1)

    with f = exp(clip(log_f, -30, 0)) and i = exp(clip(i_raw, -30, 10));
    then the gate silu(z), cast to x's dtype, and w_out.  Returns (out
    (b, t, d), the new state {"c", "n"} in f32: the prefill's final state
    or the decode step's)."""
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    nh = p["w_if"].shape[-1] // 2
    hp = p["w_q"].shape[-1] // nh
    q = (h @ p["w_q"]).reshape(b, t, nh, hp).float() * hp ** -0.5
    k = (h @ p["w_k"]).reshape(b, t, nh, hp).float()
    v = (h @ p["w_v"]).reshape(b, t, nh, hp).float()
    z = h @ p["w_z"]
    gif = (h @ p["w_if"]).float()
    i_raw = gif[..., :nh]
    log_f = F.logsigmoid(gif[..., nh:])                          # <= 0
    if state is None:
        y, c_state, n_state = mlstm_chunk_scan(q, k, v, log_f, i_raw, chunk)
    else:
        f1 = torch.exp(log_f[:, 0].clamp(-30.0, 0.0))[..., None]  # (b,h,1)
        i1 = torch.exp(i_raw[:, 0].clamp(-30.0, 10.0))[..., None]
        q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                   # (b,h,p)
        c_state = (state["c"] * f1[..., None]
                   + i1[..., None] * (k1[..., :, None] * v1[..., None, :]))
        n_state = state["n"] * f1 + i1 * k1
        num = (q1[..., None, :] @ c_state)[..., 0, :]            # (b,h,p)
        den = _max1((q1 * n_state).sum(-1).abs())
        y = (num / den[..., None])[:, None]
    y = (y.reshape(b, t, -1) * F.silu(z.float())).to(x.dtype)
    return y @ p["w_out"], {"c": c_state, "n": n_state}


def _tie(a: torch.Tensor, b) -> torch.Tensor:
    """d max(a, b) / da as JAX's (and torch's) ``maximum`` gives it: 1
    where a > b, 0.5 at a tie, 0 below."""
    return (a > b).float() + 0.5 * (a == b).float()


def _slstm_forward(gates, r, h0, c0, n0, m0):
    """``SLSTMScan``'s loop: (the gates after the recurrent add, H, C, N,
    M), each state (t, nh, b, hp).  Every per-step slice is made before
    the loop (``unbind``), so a step dispatches only its ~16 ops."""
    t, nh, b, hp4 = gates.shape
    hp = hp4 // 4
    r4 = r.repeat(1, 1, 4)
    g_all = torch.empty_like(gates)
    states = [gates.new_empty((t, nh, b, hp)) for _ in range(4)]
    z, i, f, o = (x.unbind(0) for x in g_all.view(t, nh, b, 4, hp).unbind(3))
    g_in, g_out = gates.unbind(0), g_all.unbind(0)
    hs, cs, ns, ms = (x.unbind(0) for x in states)
    h, c, n, m = h0, c0, n0, m0
    one = gates.new_ones(())
    for s in range(t):
        torch.baddbmm(g_in[s], h, r4, out=g_out[s])
        lfm = F.logsigmoid(f[s]) + m
        m = torch.maximum(lfm, i[s], out=ms[s])
        i_p = torch.exp(i[s] - m)
        f_p = torch.exp(lfm - m)
        c = torch.addcmul(f_p * c, i_p, torch.tanh(z[s]), out=cs[s])
        n = torch.addcmul(i_p, f_p, n, out=ns[s])
        h = torch.div(torch.sigmoid(o[s]) * c, torch.maximum(n, one),
                      out=hs[s])
    return (g_all, *states)


def _slstm_backward(d_h, d_c, d_n, d_m, r, g_all, big_h, big_c, big_n,
                    big_m, h0, c0, n0, m0):
    """``SLSTMScan``'s backward: (d gates, d r) from the gradients of the
    four state outputs (None: unused) and what the forward kept."""
    t, nh, b, hp4 = g_all.shape
    hp = hp4 // 4
    zi, ii, ff, oo = g_all.view(t, nh, b, 4, hp).unbind(3)

    def prev(x, x0):
        return torch.cat([x0[None], x[:-1]])
    h_prev, c_prev, n_prev, m_prev = (
        prev(x, x0) for x, x0 in zip((big_h, big_c, big_n, big_m),
                                     (h0, c0, n0, m0)))
    one = g_all.new_ones(())
    lfm = F.logsigmoid(ff) + m_prev
    i_p = torch.exp(ii - big_m)
    f_p = torch.exp(lfm - big_m)
    zt = torch.tanh(zi)
    o_p = torch.sigmoid(oo)
    den = torch.maximum(big_n, one)
    per_step = [x.unbind(0) for x in (
        o_p / den,                                 # dh -> dc
        -(big_h / den) * _tie(big_n, one),         # dh -> dn
        i_p * (1 - zt * zt),                       # dc -> dz
        big_c / den * o_p * (1 - o_p),             # dh -> do
        _tie(lfm, ii), _tie(ii, lfm),              # dm -> da, di
        torch.sigmoid(-ff),                        # dlog sig(f) -> df
        n_prev, c_prev, zt, i_p, f_p)]
    d_g = g_all.new_empty((t, nh, b, 4, hp))
    d_gs = d_g.unbind(0)
    d_z, d_i, d_f, d_o = (x.unbind(0) for x in d_g.unbind(3))
    d_in = [None if d is None else d.unbind(0) for d in (d_h, d_c, d_n, d_m)]
    zeros = g_all.new_zeros((nh, b, hp))
    dh_rec, dc, dn, dm = zeros, zeros, zeros, zeros
    r_t = r.transpose(-1, -2)
    for s in reversed(range(t)):
        (to_c, to_n, to_z, to_o, to_a, to_i, to_f, n_p, c_p, z_t, i_s,
         f_s) = (x[s] for x in per_step)
        dh = dh_rec if d_in[0] is None else dh_rec + d_in[0][s]
        if d_in[1] is not None:
            dc = dc + d_in[1][s]
        if d_in[2] is not None:
            dn = dn + d_in[2][s]
        if d_in[3] is not None:
            dm = dm + d_in[3][s]
        dct = torch.addcmul(dc, dh, to_c)
        dnt = torch.addcmul(dn, dh, to_n)
        u = torch.addcmul(dnt * n_p, dct, c_p) * f_s
        v = torch.addcmul(dnt, dct, z_t) * i_s
        dmt = dm - u - v
        da = torch.addcmul(u, dmt, to_a)
        torch.mul(dct, to_z, out=d_z[s])
        torch.addcmul(v, dmt, to_i, out=d_i[s])
        torch.mul(da, to_f, out=d_f[s])
        torch.mul(dh, to_o, out=d_o[s])
        dc, dn, dm = dct * f_s, dnt * f_s, da
        dh_rec = torch.bmm(d_gs[s].sum(2), r_t)
    d_r = torch.einsum("tnbp,tnbq->npq", h_prev, d_g.sum(3))
    return d_g.view(t, nh, b, hp4), d_r


_GRAPHS: dict = {}


def clear_graphs() -> None:
    """Drop the CUDA graphs ``SLSTMScan`` captured (and their memory)."""
    _GRAPHS.clear()


def _graphed(key, fn, inputs):
    """fn(*inputs) on the card through a CUDA graph of fn captured at the
    first call with this ``key`` (fn's shapes): the inputs are copied into
    the graph's own, and its outputs are cloned out, so each call's
    results are its own.  The first call runs fn once on a side stream
    (cuBLAS sets up there, outside the capture), then captures it."""
    entry = _GRAPHS.get(key)
    if entry is None:
        static_in = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(*static_in)
        entry = _GRAPHS[key] = (graph, static_in, static_out)
    graph, static_in, static_out = entry
    for dst, src in zip(static_in, inputs):
        dst.copy_(src)
    graph.replay()
    return tuple(x.clone() for x in static_out)


class SLSTMScan(torch.autograd.Function):
    """The sLSTM's loop over t with a backward written by hand.

    forward(gates (t, nh, b, 4hp) f32, r (nh, hp, hp) f32, h0, c0, n0,
    m0 (nh, b, hp)) -> (H, C, N, M), each (t, nh, b, hp): every step's
    h, c, n and m.  Each step is

        g = gates_t + h r (r repeated 4 times along its output: one
            ``baddbmm`` adds h r to the z, i, f and o gates),
        a = log sigmoid(f) + m,  m' = max(a, i),
        i' = exp(i - m'),  f' = exp(a - m'),
        c <- f' c + i' tanh(z),  n <- f' n + i',
        h = sigmoid(o) c / max(n, 1),

    JAX's ``slstm_block`` step, in its order of operations.  Autograd
    through such a loop records ~50 nodes a step, and its engine's time
    a node, not the card, bounds the loop; here the forward records
    none, and the backward is one reverse loop of ~20 tensor ops a step
    over what the forward kept (the gates after the recurrent add and
    the four states; everything else it recomputes for all steps at
    once).  The maximums' gradients follow JAX's: halved at a tie (n is
    1 exactly after a step from the zero state).  The initial state
    takes no gradient (the training forward starts from zeros).

    On a card, when the gates take a gradient (training), both loops run
    as CUDA graphs captured once for each shape (``_graphed``): a replay
    launches the ~8,000 kernels of a 512-token loop at once, where the
    host would dispatch them one by one.  Elsewhere (the CPU, serving)
    they run as written."""

    @staticmethod
    def forward(ctx, gates, r, h0, c0, n0, m0):
        ctx.set_materialize_grads(False)
        init = (h0, c0, n0, m0)
        ctx.graphed = gates.is_cuda and ctx.needs_input_grad[0]
        if ctx.graphed:
            out = _graphed(("fwd", gates.shape, gates.device),
                           _slstm_forward, (gates, r, *init))
        else:
            out = _slstm_forward(gates, r, *init)
        ctx.save_for_backward(r, *out, *init)
        return out[1:]

    @staticmethod
    def backward(ctx, d_h, d_c, d_n, d_m):
        saved = ctx.saved_tensors
        if ctx.graphed and d_h is not None and d_c is d_n is d_m is None:
            d_g, d_r = _graphed(
                ("bwd", d_h.shape, d_h.device),
                lambda dh, *rest: _slstm_backward(dh, None, None, None,
                                                  *rest),
                (d_h, *saved))
        else:
            d_g, d_r = _slstm_backward(d_h, d_c, d_n, d_m, *saved)
        return d_g, d_r, None, None, None, None


def slstm_block(cfg: ModelConfig, p, x, state=None):
    """The sLSTM (scalar memory, exponential gating with a stabiliser)
    block, JAX's ``slstm_block``, unsharded: the gate inputs rmsnorm(x) @
    w_in (4d, head-major: each of the nh heads of hp = d / nh holds its
    z, i, f and o gates, hp each), in f32, then the loop over t
    (``SLSTMScan``, head-major) carrying (h, c, n, m) from zeros and m =
    -30, or from ``state`` = {"h", "c", "n", "m"}, each (b, nh, hp).
    The h of every step, cast to x's dtype, goes through w_out.  Returns
    (out (b, t, d), the final {"h", "c", "n", "m"} when ``state`` was
    given, else None: JAX returns no state from the training forward,
    and its prefill passes a zero state).  Outside training on a card the
    loop dispatches its ~16 kernels a step from the host, which bounds
    it."""
    hn = rmsnorm(x, p["norm"])
    b, t, _ = hn.shape
    nh = p["r"].shape[0]
    hp = p["r"].shape[-1]
    gates = (hn @ p["w_in"]).float().reshape(b, t, nh, 4 * hp)
    gates = gates.permute(1, 2, 0, 3).contiguous()               # (t,h,b,4p)
    if state is None:
        zeros = hn.new_zeros((nh, b, hp), dtype=torch.float32)
        init = (zeros, zeros, zeros, zeros - 30.0)
    else:
        init = tuple(state[k].transpose(0, 1) for k in ("h", "c", "n", "m"))
        if any(v.requires_grad for v in init):
            raise NotImplementedError("slstm_block: no gradient of the "
                                      "carried state (JAX's training "
                                      "forward carries none)")
    states = SLSTMScan.apply(gates, p["r"].float(), *init)
    y = states[0].permute(2, 0, 1, 3).reshape(b, t, nh * hp)
    new_state = None if state is None else {
        k: v[-1].transpose(0, 1) for k, v in zip("hcnm", states)}
    return y.to(x.dtype) @ p["w_out"], new_state
