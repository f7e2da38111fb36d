"""repro_torch.models on the CPU: configs, parameters and the serving
steps of the port held against the JAX package on the same weights
(carried across with ``params_from_jax``) and numpy-seeded inputs, in
f32, for a narrow paper_llama-shaped config (MHA) and the minitron smoke
config (GQA)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jax_configs
from repro.api import MeshSpec
from repro.kernels import paged_attention as jpk
from repro.launch import steps
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import kv_pool as jkv
from repro_torch import configs as port_configs
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kv_pool as tkv

# f32 end to end; XLA and PyTorch sum matmuls and softmaxes in another
# order, so logits (O(1)) and KV differ by a few ulp per op, ~1e-7 here
STEP_TOL = 1e-4
LAYER_TOL = 1e-6

NARROW = dict(name="paper-llama-narrow", family="dense", n_layers=2,
              d_model=128, n_heads=8, n_kv_heads=8, d_ff=512, vocab=512,
              dtype="float32")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfg_pair(which: str):
    """(JAX config, port config), the same fields, f32."""
    if which == "narrow":
        return JaxModelConfig(**NARROW), ModelConfig(**NARROW)
    jcfg = dataclasses.replace(jax_configs.get_smoke("minitron_4b"),
                               dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def jax_params(jcfg, seed=0):
    return jlm.init_params(jcfg, jl.ShardCtx(), jax.random.PRNGKey(seed))


def to_port(jparams, cfg):
    return tlm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ["paper_llama", "minitron_4b",
                                  "phi35_moe_42b", "deepseek_v3_671b",
                                  "whisper_tiny", "qwen3_32b",
                                  "chameleon_34b", "zamba2_7b",
                                  "xlstm_125m"])
def test_configs_are_copies_of_jax(arch):
    for getter in ("get", "get_smoke"):
        j = getattr(jax_configs, getter)(arch)
        t = getattr(port_configs, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.hd == t.hd
    with pytest.raises(ValueError, match="unknown arch"):
        port_configs.get("no_such_arch")


# ---------------------------------------------------------- parameters
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    jcfg = dataclasses.replace(jax_configs.get_smoke("minitron_4b"),
                               dtype=dtype)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jax.tree.map(np.asarray, jax_params(jcfg))
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 3 + 9
    for path, leaf in flat_j:
        node = params
        for k in path:
            node = node[k.key]
        assert node.dtype == tlm.torch_dtype(cfg)
        bits = np.int16 if dtype == "bfloat16" else np.int32
        np.testing.assert_array_equal(
            node.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy(), leaf.view(bits))
    bad = dict(jparams, embed=jparams["embed"][:5])
    with pytest.raises(ValueError, match="embed"):
        tlm.params_from_jax(bad, cfg, device="cpu")


def test_init_params_follows_the_jax_recipe():
    jcfg, cfg = cfg_pair("minitron")
    _, jshapes = jlm.param_specs(jcfg, jl.ShardCtx())
    a = tlm.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda s: tuple(s), jshapes,
                        is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.map(lambda t: tuple(t.shape), a)
    b = tlm.init_params(cfg, seed=3, device="cpu")
    c = tlm.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.all(a["final_norm"] == 1)
    assert torch.all(a["layers"]["norm"] == 1)
    assert torch.all(a["layers"]["mlp_norm"] == 1)
    assert abs(a["embed"].std().item() - 0.02) < 2e-3
    bf = tlm.init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=3,
                         device="cpu")
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(bf["lm_head"], a["lm_head"].bfloat16())


# --------------------------------------------------------------- layers
def test_layer_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(_np(tl.rmsnorm(t(x), t(w))),
                               np.asarray(jl.rmsnorm(x, w)), atol=LAYER_TOL)
    pos_t = np.arange(5)
    pos_bt = np.stack([np.arange(5) + 7, np.arange(5) + 30])
    for pos in (pos_t, pos_bt):
        np.testing.assert_allclose(
            _np(tl.rope(t(x), t(pos), 500000.0)),
            np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
            atol=LAYER_TOL)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 24)).astype(np.float32) for _ in "gu")
    wd = rng.normal(size=(24, 16)).astype(np.float32)
    # jl.swiglu_mlp ends in a psum over 'model' (shard_map only): its
    # tp=1 math written out; the step tests below run the real one
    np.testing.assert_allclose(
        _np(tl.swiglu_mlp(t(h), t(wg), t(wu), t(wd))),
        np.asarray((jax.nn.silu(jnp.asarray(h) @ wg) * (h @ wu)) @ wd),
        atol=1e-5, rtol=1e-5)
    emb = rng.normal(size=(11, 4)).astype(np.float32)
    ids = np.asarray([[0, 10, 3]])
    np.testing.assert_array_equal(_np(tl.embed_lookup(t(emb), t(ids))),
                                  emb[ids])
    q = rng.normal(size=(3, 4, 1, 8)).astype(np.float32)
    kc = rng.normal(size=(3, 2, 12, 8)).astype(np.float32)
    vc = rng.normal(size=(3, 2, 12, 8)).astype(np.float32)
    for pos in (7, np.asarray([1, 12, 5], np.int32)):
        want = jl.decode_attention(jl.ShardCtx(), jnp.asarray(q),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pos))
        got = tl.decode_attention(t(q), t(kc), t(vc),
                                  pos if np.isscalar(pos) else t(pos))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_TOL)


def test_paged_update_cache_and_gather_match_jax():
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(7, 2, 4, 8)).astype(np.float32)
    new = rng.normal(size=(3, 2, 1, 8)).astype(np.float32)
    page_ids = np.asarray([3, 0, 6], np.int32)
    offsets = np.asarray([1, 0, 3], np.int32)
    want = jl.paged_update_cache(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(page_ids), jnp.asarray(offsets))
    got = tl.paged_update_cache(torch.from_numpy(pool.copy()),
                                torch.from_numpy(new),
                                torch.from_numpy(page_ids).long(),
                                torch.from_numpy(offsets).long())
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    table = np.asarray([[3, 5], [1, 0], [6, 2]], np.int32)
    np.testing.assert_array_equal(
        _np(tl.paged_gather(got, torch.from_numpy(table))),
        np.asarray(jl.paged_gather(want, jnp.asarray(table))))


# ------------------------------------------------------- serving steps
def _jax_prefill(jcfg, jparams, tokens, lengths):
    mesh = MeshSpec().build()
    fn, _, _ = steps.make_batched_prefill_step(jcfg, mesh)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(fn)(jparams, jnp.asarray(tokens),
                                    jnp.asarray(lengths))
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


def _jax_paged_decode(jcfg, jparams, pool, table, lengths, token, backend):
    mesh = MeshSpec().build()
    ctx = steps.make_ctx(mesh)
    pspec = jkv.pool_specs(ctx)

    def step(params, pool, page_table, lengths, token):
        return jlm.paged_decode_step(jcfg, ctx, params, pool, page_table,
                                     lengths, token, decode_backend=backend)

    fn = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(jlm.flat_specs(jcfg, ctx), pspec, P(None, None), P(None),
                  P(None, None)),
        out_specs=(P(None, ctx.model_axis), pspec), check_vma=False))
    with jax.set_mesh(mesh):
        logits, new_pool = fn(jparams, pool, jnp.asarray(table),
                              jnp.asarray(lengths), jnp.asarray(token))
    return np.asarray(logits), jax.tree.map(np.asarray, new_pool)


PS, NB = 4, 5
LENGTHS = np.asarray([16, 5, 1, 0], np.int32)   # full pages, mid, 1, pad row


@pytest.fixture(scope="module", params=["narrow", "minitron"])
def prefilled(request):
    """Both packages prefilled on one packed, right-padded prompt batch;
    the JAX results and the port's, plus the pools they were written to."""
    jcfg, cfg = cfg_pair(request.param)
    jparams = jax_params(jcfg, seed=1)
    params = to_port(jparams, cfg)
    rng = np.random.default_rng(2)
    b, t = len(LENGTHS), 16
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    jlog, jcache = _jax_prefill(jcfg, jparams, tokens, LENGTHS)
    with torch.inference_mode():
        tlog, tcache = tlm.batched_prefill_step(
            cfg, params, torch.from_numpy(tokens).long(),
            torch.from_numpy(LENGTHS))
    table = np.zeros((b, NB), np.int32)
    for i in range(b):
        table[i] = 1 + i * NB + np.arange(NB)
    table[LENGTHS == 0] = 0                          # pad row: null pages
    jpool = jkv.write_prompts(
        jkv.init_pool(jcfg, jl.ShardCtx(), 1 + b * NB, PS), jcache,
        jnp.asarray(table[:, :t // PS]), jnp.asarray(LENGTHS))
    tpool = tkv.write_prompts(tkv.init_pool(cfg, 1 + b * NB, PS, device="cpu"),
                              tcache,
                              torch.from_numpy(table[:, :t // PS]),
                              torch.from_numpy(LENGTHS))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jlog=jlog, jcache=jcache, tlog=tlog, tcache=tcache,
                jpool=jpool, tpool=tpool, table=table, rng=rng)


def test_batched_prefill_matches_jax(prefilled):
    live = LENGTHS > 0
    np.testing.assert_allclose(_np(prefilled["tlog"])[live],
                               prefilled["jlog"][live], atol=STEP_TOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(prefilled["tcache"]["layers"][name]),
                                   prefilled["jcache"]["layers"][name],
                                   atol=STEP_TOL, rtol=0)
        np.testing.assert_allclose(
            _np(prefilled["tpool"]["layers"][name]),
            np.asarray(prefilled["jpool"]["layers"][name]), atol=STEP_TOL,
            rtol=0)


@pytest.mark.parametrize("backend", ["gather", "paged"])
def test_paged_decode_step_matches_jax(prefilled, backend):
    """One decode step after the prefill: slot 0 crosses into a fresh
    page, the pad row writes into the null page.  JAX runs its gather
    path or, for 'paged', the interpreted Pallas kernel (FORCE_KERNEL);
    the port has one path, the paged wrapper, whose plain version runs
    on these CPU tensors."""
    cfg, rng = prefilled["cfg"], prefilled["rng"]
    token = rng.integers(0, cfg.vocab, (len(LENGTHS), 1)).astype(np.int32)
    jpk.FORCE_KERNEL = backend == "paged"
    try:
        jlog, jpool = _jax_paged_decode(
            prefilled["jcfg"], prefilled["jparams"], prefilled["jpool"],
            prefilled["table"], LENGTHS, token, backend)
    finally:
        jpk.FORCE_KERNEL = None
    tpool = {"layers": {k: v.clone()
                        for k, v in prefilled["tpool"]["layers"].items()}}
    with torch.inference_mode():
        tlog, tpool = tlm.paged_decode_step(
            cfg, prefilled["params"], tpool,
            torch.from_numpy(prefilled["table"]),
            torch.from_numpy(LENGTHS), torch.from_numpy(token).long())
    live = LENGTHS > 0
    np.testing.assert_allclose(_np(tlog)[live], jlog[live], atol=STEP_TOL,
                               rtol=0)
    for name in ("k", "v"):
        got = _np(tpool["layers"][name])
        want = jpool["layers"][name]
        # the null page holds whatever the pad rows wrote: compare the rest
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=STEP_TOL,
                                   rtol=0)
