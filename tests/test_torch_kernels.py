"""repro_torch.kernels on the CPU: the plain versions of the port's CUDA
kernels held against the JAX package's Pallas kernels (interpret mode)
and their jnp twins on the same numpy-seeded inputs; the wrappers'
device and input rules; and the port's import hygiene (no jax, no repro,
nothing built or loaded at import).  Nothing here builds or launches
CUDA: every tensor lies on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpk
from repro.kernels.attention import flash_attention as jax_flash
from repro.models.layers import ShardCtx
from repro.models.layers import blocked_attention as jax_blocked
from repro.models.layers import decode_attention as jax_decode
from repro.models.layers import paged_gather as jax_gather
from repro_torch.kernels import _build, attention, paged_attention, ref

ROOT = Path(__file__).resolve().parents[1]
# f32 attention, both sides summing in f32 in another order (online vs
# straight softmax, tile sizes): differences are a few ulp of O(1) values
PAGED_TOL = 2e-6
FLASH_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- paged decode
def _paged_case(h, hkv, hd, ps, seed=0, nb=3):
    """Five slots with lengths 1, ps-1, ps, ps+1 and the full table;
    pages shuffled; null page 0 zero (the pool invariant)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([1, ps - 1, ps, ps + 1, nb * ps], np.int32)
    b = len(lengths)
    n_pages = 1 + b * nb
    q = rng.normal(size=(b, h, 1, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, hkv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, hkv, ps, hd)).astype(np.float32)
    kp[0] = vp[0] = 0
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // ps)
        table[i, :used] = perm[i * nb:i * nb + used]
    return q, kp, vp, table, lengths


PAGED_SHAPES = [
    (4, 4, 16, 4),     # MHA, hd 16
    (4, 2, 16, 4),     # GQA rep 2, hd 16 (the minitron smoke heads)
    (8, 8, 48, 8),     # MHA, hd 48 (paper_llama heads)
    (8, 2, 48, 4),     # GQA rep 4, hd 48
]


def _jax_paged(q, kp, vp, table, lengths, pool_dtype=jnp.float32):
    args = (jnp.asarray(q), jnp.asarray(kp, pool_dtype),
            jnp.asarray(vp, pool_dtype), jnp.asarray(table),
            jnp.asarray(lengths))
    kernel = jpk.paged_attention(*args, interpret=True)
    gather = jax_decode(ShardCtx(), args[0], jax_gather(args[1], args[3]),
                        jax_gather(args[2], args[3]), args[4])
    return np.asarray(kernel), np.asarray(gather)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES)
def test_paged_plain_matches_jax_kernel_and_gather(h, hkv, hd, ps):
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps)
    got = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths)).numpy()
    kernel, gather = _jax_paged(q, kp, vp, table, lengths)
    np.testing.assert_allclose(got, kernel, atol=PAGED_TOL, rtol=0)
    np.testing.assert_allclose(got, gather, atol=PAGED_TOL, rtol=0)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES[1::2])
def test_paged_plain_ignores_poisoned_null_page(h, hkv, hd, ps):
    """Garbage in the null page changes nothing for slots of length >= 1:
    masking is by position against length, never by pool contents."""
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps, seed=3)
    clean = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths)).numpy()
    kp[0], vp[0] = 1e4, -1e4
    dirty = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths)).numpy()
    np.testing.assert_array_equal(dirty, clean)
    kernel, _ = _jax_paged(q, kp, vp, table, lengths)
    np.testing.assert_allclose(dirty, kernel, atol=PAGED_TOL, rtol=0)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES[1:3])
def test_paged_plain_bf16_pool_matches_jax(h, hkv, hd, ps):
    """bf16 pages: both sides round the same f32 pages to bf16 (round to
    nearest even) and widen them exactly, then compute in f32."""
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps, seed=5)
    got = ref.paged_attention_ref(
        _t(q), _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16),
        _t(table), _t(lengths)).numpy()
    kernel, gather = _jax_paged(q, kp, vp, table, lengths, jnp.bfloat16)
    np.testing.assert_allclose(got, kernel, atol=PAGED_TOL, rtol=0)
    np.testing.assert_allclose(got, gather, atol=PAGED_TOL, rtol=0)


def test_paged_wrapper_routes_cpu_to_plain_and_rejects_bad_input():
    q, kp, vp, table, lengths = (_t(a) for a in _paged_case(4, 2, 16, 4))
    before = paged_attention.paged_attention.launches
    got = paged_attention.paged_attention(q, kp, vp, table, lengths)
    assert torch.equal(got, ref.paged_attention_ref(q, kp, vp, table,
                                                    lengths))
    assert paged_attention.paged_attention.launches == before
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        paged_attention.paged_attention(q.to("meta"), kp, vp, table,
                                        lengths)
    with pytest.raises(TypeError, match="int32"):
        paged_attention.paged_attention(q, kp, vp, table, lengths.long())
    with pytest.raises(TypeError, match="f32/bf16"):
        paged_attention.paged_attention(q.half(), kp, vp, table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention.paged_attention(q, kp, vp, table[:2], lengths)
    with pytest.raises(ValueError, match=r"\(b, h, 1, hd\)"):
        paged_attention.paged_attention(q.expand(-1, -1, 2, -1), kp, vp,
                                        table, lengths)
    with pytest.raises(ValueError, match="head mismatch"):
        paged_attention.paged_attention(q[..., :8], kp, vp, table, lengths)


# ------------------------------------ paged decode: the split plan
PLAN_SHAPES = [
    # (b, h, hkv, ps, hd, nb, itemsize)
    (8, 8, 8, 16, 48, 16, 2),      # paper_llama serving (the main case)
    (1, 8, 8, 16, 48, 16, 2),      # one slot: many splits
    (64, 8, 8, 16, 48, 16, 2),     # a batch that fills the card alone
    (4, 24, 8, 4, 128, 40, 2),     # minitron_4b's heads, rep 3
    (2, 8, 2, 32, 64, 9, 4),       # rep 4, f32 pages
    (3, 8, 8, 64, 128, 5, 4),      # f32 hd 128: 32 lanes a row
]


@pytest.mark.parametrize("b,h,hkv,ps,hd,nb,item", PLAN_SHAPES)
def test_paged_plan_splits_cover_every_valid_position_once(b, h, hkv, ps,
                                                           hd, nb, item):
    """Each slot's splits partition [0, min(length, nb * page)): whole
    pages, no position twice, none at or past the length, never more
    splits than the grid has; the launch's other choices fit the row."""
    p = paged_attention.plan(b, h, hkv, ps, hd, nb, item)
    assert p.split % ps == 0 and p.split >= min(paged_attention.MIN_SPLIT,
                                                nb * ps)
    assert (p.n_splits - 1) * p.split < nb * ps <= p.n_splits * p.split
    assert p.grid == (p.n_splits, hkv * p.row_chunks, b)
    rep = h // hkv
    assert p.rows in (1, 2, 4) and p.rows * p.row_chunks >= rep
    assert (p.row_chunks - 1) * p.rows < rep
    chunks = hd * item // p.vec_bytes
    assert hd * item % p.vec_bytes == 0 and chunks <= p.group <= 32
    assert p.group & (p.group - 1) == 0 and p.group < 2 * chunks
    s = p.split
    for length in sorted({0, 1, s - 1, s, s + 1, 2 * s - 1, nb * ps - 1,
                          nb * ps, nb * ps + 7}):
        ranges = paged_attention.split_ranges(length, nb, ps, s)
        covered = [i for a, e in ranges for i in range(a, e)]
        assert covered == list(range(min(length, nb * ps)))
        assert len(ranges) <= p.n_splits
        for k, (a, e) in enumerate(ranges):
            assert a == k * s and a < e <= min(a + s, length)


def test_paged_plan_main_case_and_refusals():
    """paper_llama's decode (b 8, hkv 8, 16 pages of 16): 4 splits of 64
    positions, 16-byte loads, 8 lanes a bf16 row of hd 48; minitron_4b
    (rep 3, hd 128): 4 query rows a block.  Narrower loads where the
    pools' pointers are not 16-byte aligned; a row of more than 32 chunks
    is refused."""
    p = paged_attention.plan(8, 8, 8, 16, 48, 16, 2)
    assert (p.split, p.n_splits, p.vec_bytes, p.group, p.rows) == (
        64, 4, 16, 8, 1)
    p = paged_attention.plan(8, 24, 8, 16, 128, 16, 2)
    assert (p.rows, p.row_chunks, p.vec_bytes, p.group) == (4, 1, 16, 16)
    assert paged_attention.plan(8, 8, 8, 16, 48, 16, 2, align=8).group == 16
    assert paged_attention.plan(8, 8, 8, 16, 48, 16, 2,
                                align=4).vec_bytes == 4
    with pytest.raises(ValueError, match="32 lane chunks"):
        paged_attention.plan(8, 8, 8, 16, 48, 16, 2, align=2)
    with pytest.raises(ValueError, match="32 lane chunks"):
        paged_attention.plan(1, 1, 1, 16, 256, 4, 4)


def _split_combine(q, kp, vp, table, lengths, split):
    """The kernel's arithmetic in plain torch (f32): each split of each
    slot's valid positions (``split_ranges``) gives its own softmax state
    (m, l, acc); the valid splits are then merged in split order, M =
    max m_i, l = sum l_i e^(m_i - M), o = sum acc_i e^(m_i - M) /
    max(l, 1e-30).  A slot of length 0 has no split and gives zeros."""
    b, h, _, hd = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    rep = h // hkv
    kg = ref.paged_gather(kp, table).float()         # (b, hkv, nb*ps, hd)
    vg = ref.paged_gather(vp, table).float()
    qf = q.float().reshape(b, hkv, rep, hd) * hd ** -0.5
    out = torch.zeros((b, hkv, rep, hd))
    for i in range(b):
        parts = []
        for a, e in paged_attention.split_ranges(int(lengths[i]), nb, ps,
                                                 split):
            s = torch.einsum("grd,gkd->grk", qf[i], kg[i, :, a:e])
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("grk,gkd->grd", p, vg[i, :, a:e])))
        if not parts:
            continue
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mm) for m, _, _ in parts]
        l = sum(li * wi for (_, li, _), wi in zip(parts, w))
        acc = sum(ai * wi for (_, _, ai), wi in zip(parts, w))
        out[i] = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, 1, hd).to(q.dtype)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", [1, 2, 0])      # 0: the whole table
@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES[1:3])
def test_paged_split_and_combine_matches_jax_kernel(h, hkv, hd, ps, pages,
                                                    pool_dtype):
    """The split-and-combine arithmetic against JAX's Pallas kernel
    (interpret mode) at splits of one page, two pages and the whole
    table, with a poisoned null page and a slot of length 0 among valid
    ones (zeros here; nothing reads it)."""
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps, seed=7)
    lengths[1] = 0
    table[1] = 0
    kp[0], vp[0] = 1e4, -1e4
    nb = table.shape[1]
    split = (pages or nb) * ps
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[pool_dtype]
    tdt = getattr(torch, pool_dtype)
    got = _split_combine(_t(q), _t(kp).to(tdt), _t(vp).to(tdt), _t(table),
                         _t(lengths), split).numpy()
    kernel, _ = _jax_paged(q, kp, vp, table, lengths, jdt)
    live = lengths > 0
    np.testing.assert_allclose(got[live], kernel[live], atol=PAGED_TOL,
                               rtol=0)
    assert not got[~live].any()


# ------------------------------------------------------- flash prefill
@pytest.mark.parametrize("hd,sq,skv", [(16, 64, 64), (48, 64, 64),
                                       (16, 32, 64)])
def test_flash_plain_matches_jax_kernel_per_head(hd, sq, skv):
    """The JAX Pallas flash kernel is single-head: run it per head (32-row
    tiles, so several tiles and the diagonal skip are exercised)."""
    rng = np.random.default_rng(hd + sq)
    b, h = 1, 2
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    got = ref.attention_ref(_t(q), _t(k), _t(v)).numpy()
    for i in range(h):
        want = jax_flash(jnp.asarray(q[0, i]), jnp.asarray(k[0, i]),
                         jnp.asarray(v[0, i]), blk_q=32, blk_k=32,
                         interpret=True)
        np.testing.assert_allclose(got[0, i], np.asarray(want),
                                   atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", [
    (2, 4, 2, 16, 37, 37),    # GQA rep 2, ragged (not a tile multiple)
    (2, 8, 2, 48, 70, 70),    # GQA rep 4, paper_llama head dim
    (1, 8, 8, 48, 10, 37),    # MHA, fewer queries than keys (shifted mask)
])
def test_flash_plain_matches_jax_blocked_attention(b, h, hkv, hd, sq, skv):
    rng = np.random.default_rng(sq * skv)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    got = ref.attention_ref(_t(q), _t(k), _t(v)).numpy()
    want = jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       blk_q=16, blk_kv=16)
    np.testing.assert_allclose(got, np.asarray(want), atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("b,h,hkv,hd,hdv,sq,skv", [
    (2, 4, 4, 24, 16, 37, 37),     # deepseek_v3 SMOKE's MLA: QK 16 + 8, V 16
    (1, 2, 2, 192, 128, 20, 20),   # its published widths: QK 128 + 64, V 128
    (1, 4, 2, 24, 16, 10, 29),     # GQA, fewer queries than keys
])
def test_flash_plain_with_a_v_head_dim_matches_jax(b, h, hkv, hd, hdv, sq,
                                                   skv):
    """MLA's attention, whose V head dim differs from the QK one (scale
    hd^-0.5): the plain forward against JAX's blocked_attention, the one
    JAX trains MLA through, and the plain backward against its vjp."""
    rng = np.random.default_rng(hd * sq + hdv)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hdv)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hdv)).astype(np.float32)
    o, vjp = jax.vjp(lambda q, k, v: jax_blocked(q, k, v, blk_q=16,
                                                  blk_kv=16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = ref.attention_fwd_ref(_t(q), _t(k), _t(v))
    assert out.shape == (b, h, sq, hdv)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=FLASH_TOL,
                               rtol=0)
    got = attention.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse,
                                        _t(do))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_wrapper_routes_cpu_to_plain_and_rejects_bad_input():
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    before = attention.flash_attention.launches
    got = attention.flash_attention(q.transpose(2, 3).transpose(2, 3), k, k)
    assert torch.equal(got, ref.attention_ref(q, k, k))
    assert attention.flash_attention.launches == before
    # a V head dim of its own (MLA) is taken; a V whose rows are not K's
    # is refused
    assert torch.equal(attention.flash_attention(q, k, k[..., :8]),
                       ref.attention_ref(q, k, k[..., :8]))
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention(q, k, k[:, :, :4, :8])
    with pytest.raises(ValueError, match="skv >= sq"):
        attention.flash_attention(q, k[:, :, :4], k[:, :, :4])
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention(q[:, :3], k, k)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        attention.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_flash_wrapper_copies_rows_the_bf16_kernels_cannot_read():
    """The bf16 tensor-core kernels copy rows by 16-byte loads: a view
    whose data pointer or strides break that alignment is handed to them
    as a contiguous copy; an aligned strided view (the model's transposed
    q/k/v) is passed as it is."""
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16).transpose(1, 2)
    assert attention._kernel_rows(x) is x
    buf = torch.arange(257, dtype=torch.float32).bfloat16()
    off = buf[1:].view(1, 2, 8, 16)                 # 2 bytes off
    wide = buf[:240].view(1, 2, 6, 20)[..., :16]    # 40-byte rows
    for t in (off, wide):
        got = attention._kernel_rows(t)
        assert got is not t and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


# ------------------------------------------------- flash backward
# f32 gradients of O(1) inputs, both sides summing in f32 in other
# orders (online vs straight softmax, the JAX scan's tiles): a few ulp
BWD_TOL = 2e-5


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", [
    (2, 4, 4, 16, 37, 37),    # MHA, ragged
    (2, 8, 2, 48, 40, 40),    # GQA rep 4, paper_llama head dim
    (1, 4, 2, 16, 10, 29),    # GQA, fewer queries than keys
])
def test_attention_bwd_plain_matches_jax_grad(b, h, hkv, hd, sq, skv):
    """attention_bwd_ref against jax.vjp of the JAX blocked_attention
    (the function the JAX package trains through)."""
    rng = np.random.default_rng(h * sq + skv)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    o, vjp = jax.vjp(lambda q, k, v: jax_blocked(q, k, v, blk_q=16,
                                                  blk_kv=16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    out, lse = ref.attention_fwd_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=FLASH_TOL,
                               rtol=0)
    got = ref.attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_autograd_on_cpu_is_the_plain_backward():
    """FlashAttention's CPU route: the forward keeps the plain lse and
    the backward is attention_bwd_ref, so its gradients equal autograd
    through attention_ref up to summation order; no launch is counted."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((2, 4, 9, 16), (2, 2, 9, 16), (2, 2, 9, 16)))
    before = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
    out = attention.FlashAttention.apply(q.transpose(2, 3).transpose(2, 3),
                                         k, v)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    want = torch.autograd.grad(
        (ref.attention_ref(q, k, v) ** 2).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=0)
    assert (attention.flash_attention.launches,
            attention.flash_attention_bwd.launches) == before
    with torch.no_grad():
        assert torch.equal(attention.FlashAttention.apply(q, k, v),
                           ref.attention_ref(q, k, v))
    o, lse = attention.flash_attention(q.detach(), k.detach(), v.detach(),
                                       return_lse=True)
    want_o, want_lse = ref.attention_fwd_ref(q.detach(), k.detach(),
                                             v.detach())
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def test_flash_bwd_wrapper_rejects_bad_input():
    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    o, lse = ref.attention_fwd_ref(q, k, k)
    args = [q, k, k, o, lse, q]
    assert all(torch.equal(a, b) for a, b in zip(
        attention.flash_attention_bwd(*args), ref.attention_bwd_ref(*args)))
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention_bwd(q, k, k, o, lse[..., :4], q)
    with pytest.raises(TypeError, match="f32 lse"):
        attention.flash_attention_bwd(q, k, k, o, lse.double(), q)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_attention_bwd(q, k.bfloat16(), k, o, lse, q)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        attention.flash_attention_bwd(*(a.to("meta") for a in args))


# ------------------------------------------ flash, non-causal mode
# whisper's encoder self-attention and its decoder's cross-attention: the
# Pallas kernel's causal=False, every query over every key, any sq, skv
@pytest.mark.parametrize("hd,sq,skv", [(16, 64, 64), (32, 32, 96),
                                       (32, 96, 64)])
def test_flash_plain_non_causal_matches_jax_kernel_per_head(hd, sq, skv):
    """The single-head Pallas kernel with causal=False, per head, 32-row
    tiles (several tiles a row, none skipped), fewer and more queries
    than keys."""
    rng = np.random.default_rng(hd + sq + 3 * skv)
    b, h = 1, 2
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=False).numpy()
    for i in range(h):
        want = jax_flash(jnp.asarray(q[0, i]), jnp.asarray(k[0, i]),
                         jnp.asarray(v[0, i]), causal=False, blk_q=32,
                         blk_k=32, interpret=True)
        np.testing.assert_allclose(got[0, i], np.asarray(want),
                                   atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", [
    (2, 4, 2, 16, 37, 37),    # GQA rep 2, ragged (not a tile multiple)
    (2, 6, 6, 64, 21, 50),    # whisper's heads, cross: fewer queries
    (1, 4, 2, 32, 37, 32),    # SMOKE's head dim, more queries than keys
])
def test_flash_plain_non_causal_matches_jax_blocked_attention(b, h, hkv, hd,
                                                              sq, skv):
    """The plain forward and backward with causal=False against JAX's
    blocked_attention(causal=False), the function JAX trains whisper
    through, and jax.vjp of it; the wrappers' CPU route is the plain
    version and counts no launch."""
    rng = np.random.default_rng(sq * skv + hd)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    o, vjp = jax.vjp(lambda q, k, v: jax_blocked(
        q, k, v, causal=False, blk_q=16, blk_kv=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = (dict(attention.flash_attention.launches_by_mode),
              dict(attention.flash_attention_bwd.launches_by_mode))
    out, lse = attention.flash_attention(_t(q), _t(k), _t(v),
                                         return_lse=True, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=FLASH_TOL,
                               rtol=0)
    got = attention.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse,
                                        _t(do), causal=False)
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")
    assert (attention.flash_attention.launches_by_mode,
            attention.flash_attention_bwd.launches_by_mode) == before


def test_flash_non_causal_autograd_on_cpu_and_the_causal_refusal():
    """FlashAttention(causal=False) on the CPU is the plain non-causal
    backward (autograd through attention_ref(causal=False)), with sq >
    skv; the causal mode still refuses skv < sq, forward and backward."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((2, 4, 13, 16), (2, 2, 9, 16), (2, 2, 9, 16)))
    out = attention.FlashAttention.apply(q, k, v, False)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    want = torch.autograd.grad(
        (ref.attention_ref(q, k, v, causal=False) ** 2).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=0)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    with pytest.raises(ValueError, match="skv >= sq"):
        attention.flash_attention(qd, kd, vd)
    o, lse = attention.flash_attention(qd, kd, vd, return_lse=True,
                                       causal=False)
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention_bwd(qd, kd, vd, o, lse, qd)
    # the non-causal rows see every key: the last key moves every row
    k2 = kd.clone()
    k2[:, :, -1] += 1
    moved = (attention.flash_attention(qd, k2, vd, causal=False)
             - attention.flash_attention(qd, kd, vd, causal=False)).abs()
    assert (moved.amax(dim=-1) > 0).all()


# ------------------------------------ the tensor-core kernels' rounding
# chip_smoke.py's bf16 tolerances (kernel vs plain on the card): forward
# output max abs, backward max abs over the largest |gradient|, lse max
# abs.  An emulation of the kernels' rounding must stay within a third
# of each, so that a design whose rounding errs by more than that fails
# here before it costs a chip run.
CHIP_FWD_TOL, CHIP_BWD_TOL, CHIP_LSE_TOL = 2e-2, 3e-2, 2e-5
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulated_fwd(q, k, v):
    """The bf16 forward kernel's arithmetic on the CPU: f32 S = Q K^T of
    the bf16 inputs, scaled after the product into log2 units, the
    online softmax over 64-column tiles in f32, P rounded to bf16 before
    P V.  Returns the f32 output before its bf16 cast, and the lse."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, sq, hd)
    kf, vf = k.float(), v.float()
    rows = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, hkv, rep, sq, 1), -1e30)
    l = torch.zeros((b, hkv, rep, sq, 1))
    o = torch.zeros((b, hkv, rep, sq, hd))
    for k0 in range(0, skv, 64):
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf[:, :, k0:k0 + 64])
        s = s * np.float32(hd ** -0.5 * LOG2E)
        cols = torch.arange(k0, min(k0 + 64, skv))[None, :]
        s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bgrqk,bgkd->bgrqd", _bf16(p),
                                     vf[:, :, k0:k0 + 64])
        m = m_new
    out = o / l.clamp_min(1e-30)
    lse = m / np.float32(LOG2E) + torch.log(l.clamp_min(1e-30))
    return out.reshape(b, h, sq, hd), lse.reshape(b, h, sq)


def _emulated_bwd(q, k, v, o, lse, do):
    """The bf16 backward kernels' arithmetic on the CPU: S and dP = dO V^T
    in f32 from the bf16 inputs, P = exp2(S scale log2(e) - lse log2(e)),
    dS = P (dP - D) in f32; P and dS rounded to bf16 before dV = P^T dO,
    dK = scale dS^T Q and dQ = scale dS K."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, sq, hd)
    dof = do.float().reshape(b, hkv, rep, sq, hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float())
    l2 = lse.reshape(b, hkv, rep, sq, 1) * np.float32(LOG2E)
    p = torch.exp2(s * np.float32(hd ** -0.5 * LOG2E) - l2)
    rows = torch.arange(sq)[:, None] + (skv - sq)
    p = p.masked_fill(torch.arange(skv)[None, :] > rows, 0.0)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, v.float())
    dsum = (dof * o.float().reshape(b, hkv, rep, sq, hd)).sum(-1,
                                                                keepdim=True)
    ds = _bf16(p * (dp - dsum))
    dv = torch.einsum("bgrqk,bgrqd->bgkd", _bf16(p), dof)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf) * np.float32(hd ** -0.5)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k.float()) * np.float32(
        hd ** -0.5)
    return dq.reshape(b, h, sq, hd), dk, dv


def _bf16_case(b, h, hkv, hd, sq, skv, seed):
    rng = np.random.default_rng(seed)
    return [_t(rng.normal(size=s).astype(np.float32)).bfloat16()
            for s in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd),
                      (b, h, sq, hd))]


BF16_CASES = [
    (1, 8, 8, 48, 512, 512),    # paper_llama's heads at the training length
    (1, 8, 2, 48, 512, 512),    # GQA rep 4
    (1, 8, 2, 48, 300, 512),    # GQA, fewer queries than keys (shifted)
]


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", BF16_CASES)
def test_tensor_core_forward_rounding_fits_the_chip_tolerance(
        b, h, hkv, hd, sq, skv):
    """The forward's output in f32 before its bf16 cast (the cast alone
    can flip one bf16 ulp, 7.8e-3 at |o| in [1, 2)) and its lse."""
    q, k, v, _ = _bf16_case(b, h, hkv, hd, sq, skv, sq + hkv)
    got, lse = _emulated_fwd(q, k, v)
    want, want_lse = ref.attention_fwd_ref(q.float(), k.float(), v.float())
    assert (got - want).abs().max().item() <= CHIP_FWD_TOL / 3
    assert (lse - want_lse).abs().max().item() <= CHIP_LSE_TOL / 3


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", BF16_CASES)
def test_tensor_core_backward_rounding_fits_the_chip_tolerance(
        b, h, hkv, hd, sq, skv):
    """dq, dk, dv of the emulated kernels against attention_bwd_ref on
    the same bf16 inputs, output and lse (max abs error over the largest
    |gradient|, as chip_smoke.py compares the card's kernels), both in
    f32 before the final bf16 cast, which alone can move a gradient by
    2^-8 of its size."""
    q, k, v, do = _bf16_case(b, h, hkv, hd, sq, skv, sq + hkv + 1)
    o, lse = ref.attention_fwd_ref(q, k, v)
    got = _emulated_bwd(q, k, v, o, lse, do)
    want = ref.attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                 lse, do.float())
    for g, w, name in zip(got, want, "qkv"):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        assert rel <= CHIP_BWD_TOL / 3, f"d{name}: {rel}"


# ------------------------------------------------------------- build
def test_build_is_content_addressed_and_reuses_a_current_build(
        tmp_path, monkeypatch):
    """A library named by the hash of its source is reused as it is: no
    compiler is needed when the build is current."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == ["flash_attention", "flash_attention_bwd", "mesh_scan",
                     "onn_layer", "paged_attention", "pam4"]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc called"))
    paths = {n: _build.library_path(n) for n in names}
    assert len({p.name for p in paths.values()}) == len(names)
    for p in paths.values():
        assert p.parent == tmp_path
        p.write_bytes(b"")
    assert _build.build() == paths
    assert _build.library_path(names[0]) == paths[names[0]]


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes (csrc/*.cuh) changes the
    library path, so a stale build is never reused."""
    assert (_build.CSRC / "flash_mma.cuh").exists()
    for name in ("flash_attention.cu", "flash_mma.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_attention")
    assert _build.library_path("flash_attention") == before
    header = tmp_path / "flash_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = _build.library_path("flash_attention")
    assert edited != before
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert _build.library_path("flash_attention") not in (before, edited)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda *a: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# ------------------------------------------------------ import hygiene
def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    banned = {"jax", "jaxlib", "repro", "triton"}
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {m}" for m in mods
                      if m.split(".")[0] in banned]
    assert len(_port_sources()) > 15
    assert not found, found


def test_importing_the_trainer_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.collectives.engine\n"
            "import repro_torch.kernels.pam4, repro_torch.photonics\n"
            "from repro_torch.kernels import _build\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'repro' not in sys.modules, 'repro imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n"
            "assert not _build._ENTRIES, 'a kernel library was loaded'\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_importing_the_engine_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch.serving.engine, repro_torch.kernels.ref\n"
            "from repro_torch.kernels import _build\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'repro' not in sys.modules, 'repro imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n"
            "assert not _build._ENTRIES, 'a kernel library was loaded'\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
