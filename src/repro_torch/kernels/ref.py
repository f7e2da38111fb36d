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

``mesh_scan_blocks_ref`` is the MZI-mesh cascade of
``repro.kernels.mesh_scan`` (the ``lax.scan`` of ``photonics.mesh`` with
the block axis written out), in the arithmetic XLA compiles that scan
into; ``mix32_ref`` and ``normal_field_ref`` are its in-kernel PRNG.

``decode_attention`` and ``paged_gather`` are the JAX package's
``models.layers`` functions of those names (the gather decode path);
they live here because the paged kernel's plain version is built from
them, and ``models.layers`` re-exports them under their JAX home.
"""
from __future__ import annotations

import math

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


# ----------------------------- mesh scan ----------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant k,
    in two 16-bit halves of k so that no int64 product overflows (torch
    on the CPU has no uint32 multiply or shift)."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32_ref(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche of uint32 counter words held in int64
    (the JAX kernel's ``_mix32``)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def counter_stride(m: int) -> int:
    """Row stride of the drift's counter: m rounded up to 128, the width
    of the JAX kernel's field (it draws over its 128-lane padded rows),
    so that the port draws the JAX kernel's numbers."""
    return -(-max(m, 1) // 128) * 128


def drift_uniforms_ref(seed: int, n_layers: int, m: int,
                       dtype=torch.float32, device="cpu"):
    """The two (L, m) uniform fields behind ``normal_field_ref``: counter
    c = (l k + w) 0x9E3779B9 + seed with k = ``counter_stride(m)``, and
    from its hash words h1 = mix32(c), h2 = mix32(c ^ 0x85EBCA6B)
    u1 = ((h1 >> 8) + 1) 2^-24 in (0, 1] and u2 = (h2 >> 8) 2^-24 in
    [0, 1), both exact."""
    lw = (torch.arange(n_layers, dtype=torch.int64, device=device)[:, None]
          * counter_stride(m)
          + torch.arange(m, dtype=torch.int64, device=device)[None, :])
    c = (_mul32(lw & _M32, 0x9E3779B9) + (int(seed) & _M32)) & _M32
    h1, h2 = mix32_ref(c), mix32_ref(c ^ 0x85EBCA6B)
    two24 = torch.tensor(2.0 ** -24, dtype=dtype, device=device)
    return ((h1 >> 8).to(dtype) + 1.0) * two24, (h2 >> 8).to(dtype) * two24


def normal_field_ref(seed: int, n_layers: int, m: int,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(L, m) standard normals from one uint32 seed, counter-based (the
    JAX kernel's ``_normal_field``): the Box-Muller transform of
    ``drift_uniforms_ref``."""
    u1, u2 = drift_uniforms_ref(seed, n_layers, m, dtype, device)
    r = torch.sqrt(torch.tensor(-2.0, dtype=dtype, device=device)
                   * torch.log(u1))
    return r * torch.cos(torch.tensor(2.0 * math.pi, dtype=dtype,
                                      device=device) * u2)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, for f32 tensors: ``fmaf`` on the
    card, and the fused multiply-add XLA emits for ``ca * y + sa *
    y[perm]``.  The product is exact in f64 and the f64 sum s rounds to
    f32 as the exact sum would, unless s fell exactly on the midpoint
    between two f32 neighbours (or in f32's subnormal range) while the
    exact sum did not: only there the TwoSum error of s says which way
    to step it (to the f64 neighbour with an odd last bit, rounding to
    odd, correct for any target with 2 bits fewer than f64)."""
    cd = c.double()
    s = torch.addcmul(cd, a.double(), b.double())
    bits = s.view(torch.int64)
    check = (((bits & 0x1FFFFFFF) == 0x10000000)
             | (s.abs() < 2.0 ** -125)).nonzero(as_tuple=True)
    if check[0].numel():
        ab_ = (a.double() * b.double()).expand_as(s)[check]
        cd_, s_ = cd.expand_as(s)[check], s[check]
        bb = s_ - ab_
        err = (ab_ - (s_ - bb)) + (cd_ - bb)
        fix = (err != 0) & ((s_.view(torch.int64) & 1) == 0)
        away = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
        s = s.clone()
        s[check] = torch.where(fix, torch.nextafter(s_, away), s_)
    return s.float()


def mesh_scan_blocks_ref(signs: torch.Tensor, perm: torch.Tensor,
                         ca: torch.Tensor, sa: torch.Tensor,
                         x: torch.Tensor, *, x_block_axis: bool = False,
                         transpose: bool = False,
                         post_scale: torch.Tensor | None = None,
                         theta_std: float = 0.0,
                         seeds: torch.Tensor | None = None) -> torch.Tensor:
    """B stacked rotation-layer programs applied to ``x``.

    signs: (B, m); perm (int), ca, sa: (B, L, m); x: (..., m) shared by
    the blocks or (..., B, m) with ``x_block_axis``; returns (..., B, m).
    Per block: y = x * signs, then L layers of y <- ca y + sa y[perm],
    then y * post_scale; with ``transpose`` the layers run in reverse
    with sa negated and the signs move to the end (o^T instead of o).

    In f32 each layer is ``fma(ca, y, sa * y[perm])``, the product
    rounded and the sum rounded once with it (``fma_f32``): the form XLA
    compiles the JAX scan into, and the CUDA kernel's ``fmaf``.  In f64
    (the oracle tests) it is computed plainly.  With ``theta_std > 0``
    each block's (ca, sa) are rotated by the theta drift of its uint32
    seed (``seeds``, (B,)): eps = theta_std sqrt(1/2) (g[w] + g[perm])
    sign(w - perm) with g = ``normal_field_ref``, so a wire with no
    partner gets eps = 0 exactly."""
    n_blocks, n_layers, m = perm.shape
    dt = torch.promote_types(x.dtype, ca.dtype)
    if theta_std > 0.0 and seeds is None:
        raise ValueError("mesh_scan_blocks: theta_std > 0 needs per-block "
                         "uint32 seeds")
    batch_shape = x.shape[:-2] if x_block_axis else x.shape[:-1]
    y = x.to(dt).reshape(-1, n_blocks if x_block_axis else 1, m)
    y = y.expand(-1, n_blocks, m)
    signs, ca, sa = signs.to(dt), ca.to(dt), sa.to(dt)
    if not transpose:
        y = y * signs
    g = None
    if theta_std > 0.0:
        g = torch.stack([normal_field_ref(int(s), n_layers, m, dt, x.device)
                         for s in seeds.to(torch.int64).tolist()])
        std = torch.tensor(theta_std, dtype=dt, device=x.device)
        half = torch.tensor(0.5 ** 0.5, dtype=dt, device=x.device)
        wire = torch.arange(m, device=x.device)
    blk = torch.arange(n_blocks, device=x.device)[:, None]
    for i in range(n_layers):
        l = n_layers - 1 - i if transpose else i
        p = perm[:, l, :].long()
        c, s = ca[:, l, :], sa[:, l, :]
        if g is not None:
            gw = g[:, l, :]
            eps = std * (half * (gw + gw[blk, p])) * torch.sign(
                wire - p).to(dt)
            ce, se = torch.cos(eps), torch.sin(eps)
            c, s = c * ce - s * se, s * ce + c * se
        if transpose:
            s = -s
        yp = s * y[:, blk, p]
        y = fma_f32(c, y, yp) if dt == torch.float32 else c * y + yp
    if transpose:
        y = y * signs
    if post_scale is not None:
        y = y * post_scale.to(dt)
    return y.reshape(batch_shape + (n_blocks, m))


# ---------------------------- attention -----------------------------

def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """Scaled f32 scores (b, hkv, rep, sq, skv) of GQA attention, causally
    masked when ``causal``, and the scaled queries (b, hkv, rep, sq, hd)."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, sq, hd) * hd ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float())
    if not causal:
        return s, qf
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    return s.masked_fill(cols > rows + (skv - sq), NEG_INF), qf


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True):
    """``attention_ref`` that also returns the per-row log-sum-exp of the
    scaled scores, (b, h, sq) f32: what the backward needs to rebuild the
    probabilities."""
    b, h, sq, _ = q.shape
    s, _ = _masked_scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()) / l
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """GQA attention, straight softmax in f32.  q: (b, h, sq, hd),
    k: (b, hkv, skv, hd), v: (b, hkv, skv, hdv) with h a multiple of hkv
    (kv head = q head // rep, no repeat); hdv may differ from hd (MLA),
    and the scale is hd^-0.5.  The masks are those of
    ``repro.models.layers.blocked_attention``: causal, a query row r sees
    key columns c <= r + (skv - sq); not causal, every row sees every
    column (any sq and skv: whisper's encoder and cross-attention).
    Returns (b, h, sq, hdv) in q.dtype."""
    return attention_fwd_ref(q, k, v, causal)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor, causal: bool = True):
    """The flash-attention backward, written out: with S the scaled
    masked scores, P = exp(S - lse), D = rowsum(dO * O),
    dV = P^T dO, dS = P * (dO V^T - D), dQ = scale dS K,
    dK = scale dS^T Q.  GQA: dK/dV of a kv head sum over its rep query
    heads.  Shapes and ``causal`` as ``attention_fwd_ref`` (o and do hdv
    wide); o is its output, lse its log-sum-exp.  Returns (dq, dk, dv)
    in the input dtypes, dv hdv wide."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    s, qf = _masked_scores(q, k, causal)
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
