"""Attention, MoE and Mamba-2 blocks (counterpart of
``repro.models.blocks``):
the training/prefill branch of ``gqa_attention`` (self-attention, or
whisper's cross-attention over given K/V, causal or not; differentiable:
attention goes through the flash kernels' autograd function, and
nothing autograd saves is written in place), the paged decode step
``gqa_decode_paged``, the training branch of deepseek-v3's
``mla_attention`` (the flash kernels with a V head dim of their own),
``moe_block`` (top-k routed experts with expert-side top-C token
selection, expert-parallel over 'model', and the shared experts) and
the training/prefill branch of the Mamba-2 block (``mamba2_block`` over
``ssd_chunk_scan``, plain torch ops: the JAX package has no kernel for
it).  qwen3's and chameleon's qk-norm runs in ``_gqa_qkv``, which
training, prefill and paged decode share.

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
        h = rmsnorm(x, p["norm"])
        wq = gather_fsdp(ctx, axes, p["wq"], 0)
        q = (h @ wq).reshape(*h.shape[:2], wq.shape[-1] // cfg.hd, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"])
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


def _causal_conv(sig: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's ``dconv`` without a carried state: the causal depthwise
    conv of sig (b, t, c) with w (k, c), summed as JAX's Python ``sum``
    (0 + p_0 + p_1 + ...)."""
    k, t = w.shape[0], sig.shape[1]
    padded = F.pad(sig, (0, 0, k - 1, 0))
    return sum(padded[:, i:i + t] * w[i] for i in range(k))


def mamba2_block(cfg: ModelConfig, p, x, chunk: int = 128):
    """The Mamba-2 (SSD) block, the training/prefill branch of JAX's
    ``mamba2_block`` (``state is None``), unsharded: in-projections of
    rmsnorm(x) to x (d_inner), the gate z, B|C (2N) and dt (nh heads);
    the causal depthwise conv (k 4) on the x and B|C paths; SiLU, dt =
    softplus(dt_raw + dt_bias) and a = -exp(a_log) in f32; the SSD scan;
    the d_skip skip, the gate silu(z), cast to x's dtype, and w_out.
    jax.nn.softplus is ``logaddexp(x, 0)``, and so is this one
    (``F.softplus`` returns x above 20, which in f32 is the same value,
    but it is 2 ulp off XLA's below).  Returns (out (b, t, d), the SSD's
    final state (b, nh, hp, N))."""
    h = rmsnorm(x, p["norm"])
    b, t, _ = h.shape
    n = cfg.ssm_state
    nh = p["a_log"].shape[0]
    hp = p["w_x"].shape[-1] // nh
    xs = _causal_conv(h @ p["w_x"], p["conv_x"])
    z = h @ p["w_z"]
    bc = F.silu(_causal_conv(h @ p["w_bc"], p["conv_bc"]).float())
    xh = F.silu(xs.float()).reshape(b, t, nh, hp)
    dt = torch.logaddexp((h @ p["w_dt"]).float() + p["dt_bias"],
                         torch.zeros((), device=x.device))
    a = -torch.exp(p["a_log"].float())
    y, state = ssd_chunk_scan(xh, dt, a, bc[..., :n], bc[..., n:], chunk)
    y = y + xh * p["d_skip"][:, None]
    y = (y.reshape(b, t, -1) * F.silu(z.float())).to(x.dtype)
    return y @ p["w_out"], state
