"""ServeSession's contiguous serving path for the MoE family (phi35_moe_42b:
GQA attention and routed experts; deepseek_v3_671b: MLA over its int8
compressed cache, a shared expert, a first dense layer) and the Mamba-2
hybrid (zamba2_7b: the SSD and conv states, a KV cache for each use of
the shared block), held against the JAX package on the CPU at the SMOKE
widths in f32, with the same numpy-seeded weights (``params_from_jax``).

What is held:

* ``lm.prefill_step`` (logits and every cache leaf) and two
  ``lm.decode_step``s from its cache seeded into ``lm.init_cache``
  (logits and every leaf after each step) against JAX's jitted
  ``prefill_step``, ``init_cache`` and ``decode_step``; the int8 codes
  equal wherever JAX's ckv / sc lies more than HALF_TOL from a
  half-integer;
* ``ServeSession.generate`` against JAX's ServeSession (both on the f32
  config): the tokens equal up to the first position whose top-2
  margin is thinner than 2 LOGIT_TOL (``chip_smoke.py``'s phase 5 rule);
* ``blocks.gqa_decode`` (the paged kernel's plain version over the
  contiguous cache, one page a row) against JAX's ``decode_attention``
  branch of ``gqa_attention``;
* the bf16 hazards, each against JAX's compiled arithmetic: MLA's
  quantisation (the f32 reciprocal, the epsilon, the bf16 quotient, the
  saturating int8 cast) and the decode conv's promotion to f32 when the
  f32 conv state meets the bf16 signal;
* the cache layouts, ``seed_cache``, the expert capacity of a decode
  step at the published configs and the refusals that stay (ServeEngine,
  the paged steps, the seq-sharded cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from test_torch_zamba import assert_rel, jax_tp1, to_torch
from repro_torch import api as tapi
from repro_torch.api import build
from repro_torch.configs import get
from repro_torch.kernels import paged_attention
from repro_torch.models import blocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx, update_cache
from repro_torch.tree import leaves_with_paths, set_path

ARCHS = ["phi35_moe_42b", "deepseek_v3_671b", "zamba2_7b"]
SEED = 41
# logits relative to their largest entry, and every cache leaf (KV,
# scales, the SSD and conv states) relative to its own: f32 sums
# reordered between XLA and torch over a few layers
LOGIT_RTOL = 1e-4
STATE_RTOL = 1e-5
# the int8 codes are compared where JAX's quotient ckv / sc is farther
# than this from a half-integer (the two quotients differ by ~1e-5)
HALF_TOL = 1e-3
# phase 5's rule: tokens equal up to the first thin top-2 margin
LOGIT_TOL = 1e-3
B, T, S = 2, 11, 24          # prompt batch, prompt length, cache length


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfg_pair(arch: str, dtype: str = "float32"):
    """(JAX config, port config) of the arch's SMOKE config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int) -> dict:
    """numpy params at JAX's shapes: norms 1, the mamba layers' special
    inits (a_log 0, dt_bias 0.5, d_skip 1), the router normal * 0.5
    (routing that is not near uniform), the rest normal * 0.1 (logits of
    O(1), so greedy tokens have margins to compare)."""
    rng = np.random.default_rng(seed)
    special = {"a_log": 0.0, "dt_bias": 0.5, "d_skip": 1.0}
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        z = rng.standard_normal(shp).astype(np.float32)
        if path[-1].endswith("norm"):
            a = np.ones(shp, np.float32)
        elif path[-1] in special:
            a = np.full(shp, special[path[-1]], np.float32)
        else:
            a = z * (0.5 if path[-1] == "router" else 0.1)
        set_path(out, path, a.astype(np.float32))
    return out


def record_quotients(monkeypatch) -> list:
    """JAX's MLA quotients ckv / sc, as its jitted steps compute them:
    ``jnp.round`` (which only MLA calls in these steps) wrapped to copy
    its input to the host, in call order."""
    seen, orig = [], jnp.round

    def rnd(x, *a, **k):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), x,
                           ordered=True)
        return orig(x, *a, **k)
    monkeypatch.setattr(jnp, "round", rnd)
    return seen


def jax_steps(jcfg, p, prompt, toks):
    """JAX's prefill_step, its cache seeded into init_cache(B, S) (its
    ServeSession's ``_seed_cache``) and len(toks) decode steps, jitted
    under a 1-device shard_map: [(logits, cache)] after each."""
    def fn(p, prompt, toks):
        logits, pre = jlm.prefill_step(jcfg, ctx, p, prompt)
        outs = [(logits, pre)]
        cache = japi.ServeSession._seed_cache(
            jlm.init_cache(jcfg, ctx, B, S), pre)
        for i in range(toks.shape[0]):
            logits, cache = jlm.decode_step(jcfg, ctx, p, cache, toks[i],
                                            jnp.int32(T + i))
            outs.append((logits, cache))
        return outs
    call, ctx = jax_tp1(fn)
    return call(jax.tree.map(jnp.asarray, p), jnp.asarray(prompt),
                jnp.asarray(toks))


def port_steps(cfg, p, prompt, toks):
    """The port's prefill_step, seed_cache into init_cache(B, S) and the
    decode steps, each step's cache cloned (decode writes in place)."""
    params = tlm.params_from_jax(p, cfg, device="cpu")
    clone = lambda c: {k: clone(v) if isinstance(v, dict) else v.clone()
                       for k, v in c.items()}
    with torch.inference_mode():
        logits, pre = tlm.prefill_step(cfg, params,
                                       torch.from_numpy(prompt).long())
        outs = [(logits, clone(pre))]
        cache = build.seed_cache(tlm.init_cache(cfg, B, S, "cpu"), pre)
        for i in range(toks.shape[0]):
            logits, cache = tlm.decode_step(
                cfg, params, cache, torch.from_numpy(toks[i]).long(), T + i)
            outs.append((logits, clone(cache)))
    return outs


def near_half(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return np.abs(q - np.floor(q) - 0.5) <= HALF_TOL


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, monkeypatch):
    """prefill_step over a (2, 11) prompt and two decode steps from its
    cache seeded into a 24-long one: the logits within LOGIT_RTOL and
    every cache leaf within STATE_RTOL of its largest entry (the int8
    codes equal away from a half-integer quotient, the columns past the
    position zero, as JAX's), after the prefill and after each step."""
    jcfg, cfg = cfg_pair(arch)
    p = np_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (2, B, 1)).astype(np.int32)
    quotients = record_quotients(monkeypatch) if cfg.mla else None
    want = jax_steps(jcfg, p, prompt, toks)
    got = port_steps(cfg, p, prompt, toks)
    empty = tlm.init_cache(cfg, B, S, "cpu")
    near = near_half_codes(cfg, quotients) if cfg.mla else None
    for step, ((logits, cache), (jlogits, jcache)) in enumerate(
            zip(got, want)):
        assert logits.shape == (B, cfg.vocab)
        assert_rel(logits.numpy(), jlogits, LOGIT_RTOL, f"{step} logits")
        paths = [path for path, _ in leaves_with_paths(cache)]
        assert paths == [path for path, _ in leaves_with_paths(empty)]
        for path, t in leaves_with_paths(cache):
            ref = np.asarray(jcache[path[0]][path[1]])
            what = f"step {step} {'/'.join(path)}"
            assert t.shape == ref.shape, what
            assert str(t.dtype).split(".")[-1] == str(ref.dtype), what
            if path[1] == "ckv":
                skip = near[path[0]][:, :, :t.shape[2]]
                assert np.all((t.numpy() == ref) | skip), what
                assert skip.mean() < 0.01, what
            else:
                assert_rel(t.float().numpy(), ref, STATE_RTOL, what)
        if step and cfg.mla:                 # nothing past the position
            assert not cache["moe"]["ckv"][:, :, T + step:].any()


def near_half_codes(cfg, quotients) -> dict:
    """Where JAX's quotient ckv / sc of each (layer, row, position,
    channel) of the decode cache lies within HALF_TOL of a half-integer,
    from the quotients its steps computed in order: the prefill's
    (dense layers, then MoE layers, (B, T, kvr) each), then each decode
    step's (the same layers, (B, kvr) each)."""
    nd = cfg.first_dense_layers
    counts = {"dense": nd, "moe": cfg.n_layers - nd}
    near = {k: np.zeros((n, B, S, cfg.kv_lora_rank), bool)
            for k, n in counts.items()}
    it = iter(quotients)
    for kind, n in counts.items():
        for i in range(n):
            near[kind][i, :, :T] = near_half(next(it))
    for step in range((len(quotients) - cfg.n_layers) // cfg.n_layers):
        for kind, n in counts.items():
            for i in range(n):
                near[kind][i, :, T + step] = near_half(next(it))
    assert next(it, None) is None
    return near


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_session(arch, monkeypatch):
    """ServeSession.generate (the unpadded prompt's prefill, its cache
    seeded, greedy decode steps) against JAX's ServeSession.generate on
    the same f32 config and weights: the tokens equal up to the first
    position where the port's teacher-forced top-2 margin is thinner
    than 2 LOGIT_TOL; prompts of 13 tokens (padding them to pages would
    change the MoE's capacity and the states)."""
    jcfg, cfg = cfg_pair(arch)
    p = np_params(cfg, SEED + 2)
    monkeypatch.setattr(japi.RunSpec, "model_config", lambda self: jcfg)
    spec = tapi.RunSpec(arch=arch, smoke=True)
    sess = tapi.ServeSession(spec, tlm.params_from_jax(p, cfg, "cpu"),
                             device="cpu", cfg=cfg)
    jsess = japi.ServeSession(japi.RunSpec(arch=arch, smoke=True),
                              params=jax.tree.map(jnp.asarray, p))
    prompts = np.random.default_rng(SEED + 3).integers(0, cfg.vocab,
                                                       (3, 13))
    new = 8
    want = np.asarray(jsess.generate(prompts, gen_len=new, max_seq=32))
    got = sess.generate(prompts, gen_len=new, max_seq=32)
    assert got.shape == (3, new)
    with torch.inference_mode():
        logits, pre = sess.prefill(prompts)
        cache = build.seed_cache(sess.new_cache(3, 32), pre)
        forced = [logits]
        for j in range(new - 1):
            logits, cache = sess.decode(cache, want[:, j:j + 1], 13 + j)
            forced.append(logits)
    top2 = torch.stack(forced, 1).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    compared = 0
    for i in range(len(prompts)):
        thin = np.nonzero(margin[i] < 2 * LOGIT_TOL)[0]
        upto = int(thin[0]) if thin.size else new
        np.testing.assert_array_equal(got[i, :upto].numpy(), want[i, :upto])
        compared += upto
    assert compared >= 2 * new, compared           # margins are O(0.1)


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("dtype,qk_norm", [("float32", False),
                                           ("bfloat16", False),
                                           ("float32", True)],
                         ids=["f32", "bf16", "qk_norm"])
def test_gqa_decode_matches_jax_decode_attention(dtype, qk_norm):
    """blocks.gqa_decode (update_cache, then the paged kernel's plain
    version over the (b, kvl, S, hd) cache as b pages of S positions)
    against the cache branch of JAX's gqa_attention (update_cache, then
    decode_attention): the output within LOGIT_RTOL (bf16: 1e-2, one
    bf16 rounding of the output apart) and the written cache within
    STATE_RTOL (the new K and V are f32 products summed in other
    orders; bf16: equal but for a rounding of the new column)."""
    jcfg, cfg = cfg_pair("phi35_moe_42b", dtype)
    jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
    cfg = dataclasses.replace(cfg, qk_norm=qk_norm)
    p = {k: v[0] for k, v in np_params(cfg, SEED + 4)["moe_layers"].items()
         if k in ("norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm")}
    rng = np.random.default_rng(SEED + 5)
    kvl, pos = cfg.n_kv_heads, 9
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, kvl, S, cfg.hd)).astype(np.float32)
              for _ in range(2))
    jdt = getattr(jnp, dtype)

    def jf(p, x, kc, vc):
        return jblocks.gqa_attention(ctx, jcfg, p, x, jnp.full((1,), pos),
                                     cache={"k": kc, "v": vc},
                                     cache_pos=jnp.int32(pos))
    call, ctx = jax_tp1(jf)
    jout, jcache = call(*jax.tree.map(lambda a: jnp.asarray(a).astype(jdt),
                                      (p, x, kc, vc)))
    tdt = getattr(torch, dtype)
    tp = {k: v.to(tdt) for k, v in to_torch(p).items()}
    cache = {"k": torch.from_numpy(kc).to(tdt),
             "v": torch.from_numpy(vc).to(tdt)}
    with torch.inference_mode():
        out, new = blocks.gqa_decode(cfg, tp, torch.from_numpy(x).to(tdt),
                                     pos, cache)
    assert new["k"] is cache["k"]                  # written in place
    tol = LOGIT_RTOL if dtype == "float32" else 1e-2
    assert_rel(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
               tol, "out")
    for k in ("k", "v"):
        ref = np.asarray(jcache[k].astype(jnp.float32))
        got = new[k].float().numpy()
        assert_rel(got, ref, STATE_RTOL if dtype == "float32" else 1e-2, k)
        np.testing.assert_array_equal(np.delete(got, pos, axis=2),
                                      np.delete(ref, pos, axis=2))


@pytest.mark.parametrize("h,hkv,hd", [(32, 8, 128), (32, 32, 112)],
                         ids=["phi35", "zamba2"])
def test_paged_plan_takes_the_cache_as_one_page_a_row(h, hkv, hd):
    """The paged kernel's launch for a bf16 contiguous cache of S 160 as
    8 pages, one a row (phi35's and zamba2's heads at b 8): one split of
    the whole row, 16-byte loads, the rep = h / hkv query rows of a kv
    head in one block (at most 4)."""
    p = paged_attention.plan(8, h, hkv, 160, hd, 1, 2)
    assert (p.split, p.n_splits, p.vec_bytes) == (160, 1, 16)
    assert p.rows == min(h // hkv, 4) and p.group == 16
    assert p.grid == (1, hkv * p.row_chunks, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_quantisation_matches_jax(dtype):
    """blocks.quantize_ckv against JAX's ``max|ckv| / 127.0 + 1e-8``,
    ``round(ckv / sc).astype(int8)`` jitted: the scale leaf and the
    codes bit for bit, at every magnitude (rows scaled 1e-3 to 1e2, a
    zero row).  In bf16 XLA rounds the product with f32(1/127) to bf16,
    adds the bf16 epsilon in f32 and keeps that f32 sum for the scale
    leaf, divides by the scale rounded to bf16, rounds the quotient to
    bf16 and saturates the int8 cast: a row's largest entry can give a
    bf16 quotient of 127.5, which rounds to 128 and is 127 in JAX (and
    -128 in torch's wrapping cast)."""
    rng = np.random.default_rng(SEED + 6)
    x = (rng.standard_normal((4096, 64))
         * 10.0 ** rng.uniform(-3, 2, (4096, 1))).astype(np.float32)
    x[7] = 0.0
    jdt = getattr(jnp, dtype)

    def jf(ckv):
        sc = jnp.max(jnp.abs(ckv), axis=-1, keepdims=True) / 127.0 + 1e-8
        return (jnp.round(ckv / sc).astype(jnp.int8), sc.astype(jnp.float32),
                (ckv / sc).astype(jnp.float32))
    xj = jnp.asarray(x).astype(jdt)
    codes, scale, quot = jax.jit(jf)(xj)
    t = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got_codes, got_scale = blocks.quantize_ckv(t)
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(scale))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    saturated = np.asarray(quot).astype(jdt) >= 127.5
    if dtype == "bfloat16":
        assert saturated.any()                      # the hazard is here
    assert np.all(np.asarray(codes)[saturated] == 127)


def test_mamba2_decode_conv_promotes_as_jax():
    """One bf16 decode step of mamba2_block from a carried f32 state: the
    concatenation of the f32 conv rows and the bf16 signal promotes, so
    the conv, its new rows and the SSD update run in f32 (the prefill's
    conv is bf16); the output within 1e-2 (one bf16 rounding) and the
    new states within STATE_RTOL of JAX's, the conv rows equal."""
    jcfg, cfg = cfg_pair("zamba2_7b", "bfloat16")
    p = {k: v[0] for k, v in np_params(cfg, SEED + 7)["mamba"].items()}
    rng = np.random.default_rng(SEED + 8)
    di, n = 2 * cfg.d_model, cfg.ssm_state
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = {"ssm": rng.standard_normal((2, di // 64, 64, n)),
             "conv_x": rng.standard_normal((2, 3, di)),
             "conv_bc": rng.standard_normal((2, 3, 2 * n))}
    state = {k: v.astype(np.float32) for k, v in state.items()}

    def jf(p, x, st):
        return jblocks.mamba2_block(ctx, jcfg, p, x, state=st)
    call, ctx = jax_tp1(jf)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    jout, jst = call(jp, jnp.asarray(x).astype(jnp.bfloat16),
                     jax.tree.map(jnp.asarray, state))
    tp = {k: v.to(torch.bfloat16) for k, v in to_torch(p).items()}
    with torch.inference_mode():
        out, st = blocks.mamba2_block(
            cfg, tp, torch.from_numpy(x).to(torch.bfloat16),
            {k: torch.from_numpy(v) for k, v in state.items()})
    assert out.dtype == torch.bfloat16
    assert_rel(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
               1e-2, "out")
    for k in ("conv_x", "conv_bc"):
        assert st[k].dtype == torch.float32 and jst[k].dtype == jnp.float32
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    assert_rel(st["ssm"].numpy(), jst["ssm"], STATE_RTOL, "ssm")
    # the promotion itself: JAX's dconv with prev is f32
    conv = jnp.concatenate([jnp.zeros((1, 3, 4)),
                            jnp.ones((1, 1, 4), jnp.bfloat16)], axis=1)
    assert conv.dtype == jnp.float32


# ------------------------------------------------------- the cache tree
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_jaxs_layout(arch):
    """lm.init_cache's leaves, shapes and dtypes are JAX's init_cache's
    (bf16 config), all zero."""
    jcfg, cfg = cfg_pair(arch, "bfloat16")
    want = jlm.init_cache(jcfg, jlayers.ShardCtx(), 3, 20)
    got = tlm.init_cache(cfg, 3, 20, "cpu")
    for path, t in leaves_with_paths(got):
        ref = want[path[0]][path[1]]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
        assert not t.any()
    assert len(list(leaves_with_paths(got))) == len(jax.tree.leaves(want))


def test_seed_cache_takes_states_and_writes_kv_at_zero():
    """seed_cache: a leaf of the decode cache's shape is taken as it is
    (cast), a shorter one written at offset 0, the rest left zero."""
    full = {"a": {"k": torch.zeros((2, 3, 8, 4))},
            "s": {"ssm": torch.zeros((2, 5))}}
    pre = {"a": {"k": torch.ones((2, 3, 5, 4), dtype=torch.bfloat16)},
           "s": {"ssm": torch.full((2, 5), 2.0, dtype=torch.float64)}}
    out = build.seed_cache(full, pre)
    assert out["a"]["k"] is full["a"]["k"]
    assert torch.all(out["a"]["k"][:, :, :5] == 1)
    assert not out["a"]["k"][:, :, 5:].any()
    assert out["s"]["ssm"].dtype == torch.float32
    assert torch.all(out["s"]["ssm"] == 2)


def test_decode_capacity_at_the_published_configs():
    """A decode step routes its b tokens with JAX's capacity rule: at b 8
    int(8 * 2 / 16 * 1.25) + 1 = 2 tokens an expert for phi35 and int(8
    * 8 / 256 * 1.25) + 1 = 1 for deepseek_v3, so decode drops tokens as
    JAX's does."""
    assert blocks.capacity(get("phi35_moe_42b"), 8) == 2
    assert blocks.capacity(get("deepseek_v3_671b"), 8) == 1
    assert blocks.capacity(get("deepseek_v3_671b"), 8 * 128) == 41


def test_what_stays_refused():
    """ServeEngine and the paged steps for these families, and the
    seq-sharded cache stay refused by name; whisper's contiguous path
    (refused until its slice) now serves and sizes its cache as JAX's."""
    whisper = get("whisper_tiny")
    assert tapi.ServeSession(tapi.RunSpec(arch="whisper_tiny", smoke=True),
                             device="cpu").contiguous
    cache = tlm.init_cache(whisper, 1, 8, "cpu")
    assert {k: tuple(v["k"].shape) for k, v in cache.items()} == {
        k: (whisper.n_layers, 1, whisper.n_kv_heads, 8, whisper.hd)
        for k in ("self", "cross")}
    for arch in ARCHS:
        _, cfg = cfg_pair(arch)
        sess = tapi.ServeSession(tapi.RunSpec(arch=arch, smoke=True),
                                 device="cpu", cfg=cfg)
        with pytest.raises(NotImplementedError, match="not ported"):
            sess.engine()
        with pytest.raises(NotImplementedError, match="contiguous steps"):
            tlm.paged_decode_step(cfg, {}, {}, None, None, None)
    with pytest.raises(NotImplementedError, match="paged steps"):
        tlm.prefill_step(get("paper_llama"), {}, torch.zeros((1, 2)))
    with pytest.raises(NotImplementedError, match="seq_shard_cache"):
        update_cache(torch.zeros((1, 1, 4, 2)), torch.zeros((1, 1, 1, 2)),
                     0, ShardCtx(dp=2, seq_shard_cache=True))
    with pytest.raises(tapi.SpecError, match="seq-sharded"):
        tapi.ServeSession(tapi.RunSpec(arch="zamba2_7b", smoke=True),
                          device="cpu", seq_shard_cache=True)
