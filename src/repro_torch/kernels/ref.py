"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

Each kernel wrapper runs its plain version for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against it on the card.  Both
compute in float32 whatever the input dtype, like the TPU kernels.

The pam4 pair follows the training path's math
(``repro.collectives.backends._encode``/``_quantized_sync``), which the
TPU kernels compute too: encode adds the zero-block guard, and decode
fuses Q(mean) (the JAX ``pam4_qmean_ref``) with dequantization, as the
Pallas decode kernel does.

``decode_attention`` and ``paged_gather`` are the JAX package's
``models.layers`` functions of those names (the gather decode path);
they live here because the paged kernel's plain version is built from
them, and ``models.layers`` re-exports them under their JAX home.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30   # finite: exp(NEG_INF - m) == 0.0 for any finite m
F32_TINY = torch.finfo(torch.float32).tiny   # the zero-block scale floor


# ------------------------------- pam4 -------------------------------

def pam4_quantize_encode_ref(g: torch.Tensor, scale: torch.Tensor,
                             bits: int, block: int) -> torch.Tensor:
    """Block-quantize f32 rows to offset-binary B-bit codes.

    g: (rows, m) f32, e.g. one bucket of every peer; scale: (nblocks,)
    per-block scales shared by every row, nblocks = ceil(m / block).
    Returns int32 (rows, nblocks, block): ``clip(round(g / s * levels),
    +-levels) + levels``, round half to even; the ragged tail is padded
    with zeros first (as ``jnp.pad``), and a block whose scale is at the
    f32-tiny floor (all zero on every peer) gets the zero code
    ``levels`` (the guard of ``backends._encode``)."""
    levels = 2 ** (bits - 1) - 1
    rows, m = g.shape
    nb = scale.shape[0]
    blocks = F.pad(g.float(), (0, nb * block - m)).reshape(rows, nb, block)
    zero = scale <= F32_TINY
    safe = torch.where(zero, 1.0, scale)
    q = torch.round(blocks / safe[:, None] * levels)
    q = q.clamp(-levels, levels).to(torch.int32)
    q = torch.where(zero[:, None], 0, q)
    return q + levels


def pam4_decode_dequantize_ref(total: torch.Tensor, scale: torch.Tensor,
                               bits: int, n: int, m: int,
                               base: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Q(mean) fused with dequantization.

    total: (rows, nblocks * block) int32, each row the sum of n peers'
    codes (n = 1: one peer's own codes, which decodes its local
    quantized gradient); scale: (nblocks,) shared by every row.  Returns
    f32 (rows, m): ``(round(total / n) - levels) * (safe / levels)``,
    round half to even, with the zero-block guard's safe scale and the
    pad columns dropped.  With ``base`` ((rows, m) f32) it returns
    ``base - decoded`` instead, the error-feedback term, rounded once.

    This is the arithmetic of the JAX training step as XLA compiles it
    (on the CPU, and the Pallas kernels in interpret mode): a division
    by a compile-time constant (``/ n``, ``/ levels``) becomes a product
    with the f32 reciprocal, and ``flat - q * r`` is contracted into one
    fused multiply-add.  Here the fused form is computed in f64, exact
    for these operands: q is an integer below 2^16, so q * r is exact,
    and |q * r| is within a factor 2 of |base| or zero, so the f64
    difference is exact and rounds once to f32."""
    levels = 2 ** (bits - 1) - 1
    rows = total.shape[0]
    nb = scale.shape[0]
    one = torch.ones((), dtype=torch.float32, device=total.device)
    safe = torch.where(scale <= F32_TINY, 1.0, scale)
    rcp = (safe * (one / levels))[:, None]
    q = torch.round(total.float() * (one / n)).reshape(rows, nb, -1) - levels
    if base is None:
        return (q * rcp).reshape(rows, -1)[:, :m]
    qr = (q.double() * rcp.double()).reshape(rows, -1)[:, :m]
    return (base.double() - qr).float()


# ----------------------------- onn layer ----------------------------

def onn_layer_ref(x: torch.Tensor, u: torch.Tensor, d: torch.Tensor,
                  b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Fused ONN layer: y = act(d * (x @ u^T) + b).

    x: (rows, n), u: (m, n), d: (m,), b: (m,); f32."""
    y = x.float() @ u.float().T * d.float() + b.float()
    return torch.relu(y) if relu else y


# ---------------------------- attention -----------------------------

def _causal_scores(q: torch.Tensor, k: torch.Tensor):
    """Scaled, masked f32 scores (b, hkv, rep, sq, skv) of GQA attention
    and the scaled queries (b, hkv, rep, sq, hd)."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, sq, hd) * hd ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float())
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    return s.masked_fill(cols > rows + (skv - sq), NEG_INF), qf


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``attention_ref`` that also returns the per-row log-sum-exp of the
    scaled scores, (b, h, sq) f32: what the backward needs to rebuild the
    probabilities."""
    b, h, sq, _ = q.shape
    s, _ = _causal_scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()) / l
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, straight softmax in f32.  q: (b, h, sq, hd),
    k/v: (b, hkv, skv, hd) with h a multiple of hkv (kv head = q head //
    rep, no repeat).  The masks are those of
    ``repro.models.layers.blocked_attention``: a query row r sees key
    columns c <= r + (skv - sq).  Returns (b, h, sq, hd) in q.dtype."""
    return attention_fwd_ref(q, k, v)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor):
    """The flash-attention backward, written out: with S the scaled
    masked scores, P = exp(S - lse), D = rowsum(dO * O),
    dV = P^T dO, dS = P * (dO V^T - D), dQ = scale dS K,
    dK = scale dS^T Q.  GQA: dK/dV of a kv head sum over its rep query
    heads.  Shapes as ``attention_fwd_ref``; o is its output, lse its
    log-sum-exp.  Returns (dq, dk, dv) in the input dtypes."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    s, qf = _causal_scores(q, k)
    p = torch.exp(s - lse.reshape(b, hkv, rep, sq, 1))
    dof = do.float().reshape(b, hkv, rep, sq, -1)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, dof)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, v.float())
    dsum = (dof * o.float().reshape(b, hkv, rep, sq, -1)).sum(-1,
                                                                keepdim=True)
    ds = p * (dp - dsum)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k.float()) * hd ** -0.5
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf)      # qf holds the scale
    return (dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
