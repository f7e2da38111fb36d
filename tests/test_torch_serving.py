"""repro_torch.serving on the CPU: ServeConfig, the allocator, the
scheduler and the prompt scatter held against their JAX counterparts,
and the port's ServeEngine against the JAX ServeEngine on the same f32
weights: greedy tokens equal under staggered load (against both JAX
decode backends; the port has one, the paged kernel's), with a bf16 pool,
and under preemption.  Every engine here is given ``device='cpu'``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.api import AdamWConfig, DataConfig, RunSpec, SyncConfig
from repro.models import lm as jlm
from repro.models.layers import ShardCtx
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import kv_pool as jkv
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kv_pool as tkv
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import ServeEngine, sample_seed
from repro_torch.serving.scheduler import QueueFull, Scheduler


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -------------------------------------------------------------- config
def test_serve_config_is_a_copy_of_jax():
    """Every JAX field, hot-swap's reload_every and decode_backend
    included (both decode backends run the paged kernel in the port)."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxServeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    assert tf == jf
    for kw in (dict(), dict(page_size=4, max_seq=30, max_active=3),
               dict(page_size=16, max_seq=256, pages=41)):
        j, t = JaxServeConfig(**kw), ServeConfig(**kw)
        assert (j.max_blocks, j.capacity, j.auto_pages()) \
            == (t.max_blocks, t.capacity, t.auto_pages())
    for bad, match in ((dict(page_size=0), "page_size"),
                       (dict(temperature=-1.0), "temperature"),
                       (dict(kv_dtype="fp8"), "kv_dtype"),
                       (dict(pages=-1), "pages"),
                       (dict(stop_token=-2), "stop_token"),
                       (dict(reload_every=-1), "reload_every"),
                       (dict(decode_backend="flash"), "decode_backend")):
        with pytest.raises(ValueError, match=match):
            ServeConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JaxServeConfig(**bad)


# ----------------------------------------------------- allocator, sched
def test_allocator_cases():
    a = tkv.PageAllocator(8)                     # 7 usable pages
    got = a.alloc(4)
    assert tkv.NULL_PAGE not in got and len(set(got)) == 4
    assert a.alloc(4) is None and a.free_pages == 3   # all or nothing
    a.free(got[:2])
    assert set(a.alloc(2)) == set(got[:2])
    with pytest.raises(ValueError, match="not allocated"):
        a.free([tkv.NULL_PAGE])
    a.free(got[2:])
    with pytest.raises(ValueError, match="not allocated"):
        a.free(got[2:])
    with pytest.raises(ValueError, match="null page"):
        tkv.PageAllocator(1)


def test_scheduler_admission_growth_and_preemption():
    cfg = ServeConfig(page_size=4, max_active=2, max_seq=16, max_queue=3,
                      pages=6)                   # 5 usable pages
    sched = Scheduler(cfg, tkv.PageAllocator(cfg.auto_pages()))
    r0 = sched.submit([1] * 8, 4)                # 2 pages
    r1 = sched.submit([2] * 9, 4)                # 3 pages
    r2 = sched.submit([3], 2)
    with pytest.raises(QueueFull):
        sched.submit([4], 1)
    with pytest.raises(ValueError, match="capacity"):
        Scheduler(cfg, tkv.PageAllocator(6)).submit([1] * 14, 3)
    with pytest.raises(ValueError, match="empty"):
        sched.submit([], 1)
    new = sched.admit()
    assert [s.req.rid for s in new] == [r0, r1]   # max_active reached
    assert [r.rid for r in sched.queue] == [r2]
    s0, s1 = new
    assert sched.grow(s0) is False               # needs a 3rd page: pool dry
    s1.req.generated.append(7)
    victim = sched.preempt_youngest()
    assert victim is s1 and sched.n_preempted == 1
    assert [r.rid for r in sched.queue] == [r1, r2]  # re-queued at front
    assert sched.queue[0].generated == [7]
    assert sched.grow(s0) is True and len(s0.pages) == 3
    sched.finish(s0)
    readmit = sched.admit()
    assert readmit[0].req.rid == r1 and readmit[0].length == 10
    assert sched.has_work()


# ----------------------------------------------------------- the pool
def test_init_pool_layout_and_kv_dtype():
    cfg = ModelConfig(**dataclasses.asdict(
        jax_configs.get_smoke("minitron_4b")))
    pool = tkv.init_pool(cfg, n_pages=6, page_size=4, device="cpu")
    k = pool["layers"]["k"]
    assert tuple(k.shape) == (cfg.n_layers, 6, cfg.n_kv_heads, 4, cfg.hd)
    assert k.dtype == torch.bfloat16 and not k.any()
    f32 = tkv.init_pool(cfg, 6, 4, "f32", device="cpu")
    assert f32["layers"]["v"].dtype == torch.float32
    assert tkv.supports_paged(cfg)
    assert not tkv.supports_paged(dataclasses.replace(cfg, ssm="mamba2"))
    with pytest.raises(NotImplementedError):
        tkv.init_pool(dataclasses.replace(cfg, moe=True), 6, 4,
                      device="cpu")


def test_write_prompts_matches_jax():
    """Pages out of order, a mid-page length, a pad row; pad-token KV is
    zeroed and the null page re-zeroed, bit for bit as in JAX."""
    rng = np.random.default_rng(0)
    n_layers, kvl, ps, hd, t = 2, 2, 4, 8, 12
    lengths = np.asarray([12, 6, 0], np.int32)
    table = np.asarray([[5, 2, 7], [3, 1, 0], [0, 0, 0]], np.int32)
    cache = {"layers": {n: rng.normal(size=(n_layers, 3, kvl, t, hd))
                        .astype(np.float32) for n in ("k", "v")}}
    pool = rng.normal(size=(n_layers, 9, kvl, ps, hd)).astype(np.float32)
    want = jkv.write_prompts(
        {"layers": {n: jnp.asarray(pool) for n in ("k", "v")}},
        jax.tree.map(jnp.asarray, cache), jnp.asarray(table),
        jnp.asarray(lengths))
    got = tkv.write_prompts(
        {"layers": {n: torch.from_numpy(pool.copy()) for n in ("k", "v")}},
        jax.tree.map(torch.from_numpy, cache), torch.from_numpy(table),
        torch.from_numpy(lengths))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][n].numpy(),
                                      np.asarray(want["layers"][n]))
        assert not got["layers"][n][:, tkv.NULL_PAGE].any()


# ---------------------------------------------------------- the engine
def _jax_spec(**serve_kw):
    return RunSpec(arch="minitron_4b", smoke=True, steps=6,
                   sync=SyncConfig(mode="optinc", bits=8, block=256),
                   optim=AdamWConfig(lr=1e-3),
                   data=DataConfig(vocab=0, seq_len=32, global_batch=2,
                                   seed=0),
                   serve=JaxServeConfig(**serve_kw))


def _f32_pair(seed=0):
    """minitron smoke in f32: JAX params and the same weights in the port.
    The JAX engine computes in its params' dtype, and an f32 pool
    (kv_dtype='f32') keeps its KV in f32 too."""
    jcfg = dataclasses.replace(jax_configs.get_smoke("minitron_4b"),
                               dtype="float32")
    jparams = jlm.init_params(jcfg, ShardCtx(), jax.random.PRNGKey(seed))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jparams, cfg, tlm.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(3, 11)),)).tolist()
            for _ in range(n)]


def _staggered(eng, prompts, budgets):
    """Half the requests up front, then one per step."""
    rids = [eng.submit(p, b) for p, b in zip(prompts[:5], budgets[:5])]
    pending = list(zip(prompts[5:], budgets[5:]))
    while eng.has_work() or pending:
        if pending:
            rids.append(eng.submit(*pending.pop(0)))
        eng.step()
    return rids


def _staggered_pair(kv_dtype, jax_backend):
    """The port's engine and the JAX engine (decode backend
    ``jax_backend``) on the same f32 weights and staggered load; returns
    (results, rids) of each and the budgets."""
    serve_kw = dict(page_size=4, max_active=8, max_seq=32, max_queue=32,
                    kv_dtype=kv_dtype)
    jparams, cfg, params = _f32_pair()
    prompts = _prompts(10, cfg.vocab)
    budgets = [4 + (i % 5) * 2 for i in range(10)]
    jeng = JaxServeEngine(_jax_spec(decode_backend=jax_backend, **serve_kw),
                          params=jparams)
    jrids = _staggered(jeng, prompts, budgets)
    eng = ServeEngine(cfg, ServeConfig(**serve_kw), params, device="cpu")
    rids = _staggered(eng, prompts, budgets)
    assert eng.max_observed_active == jeng.max_observed_active == 8
    return eng, rids, jeng, jrids, budgets


@pytest.mark.parametrize("backend", ["gather", "paged"])
def test_engine_greedy_tokens_match_jax_under_staggered_load(backend):
    """The port decodes through the paged kernel's wrapper (its plain
    version on these CPU tensors); JAX through either of its backends."""
    eng, rids, jeng, jrids, budgets = _staggered_pair("f32", backend)
    for jr, r, b in zip(jrids, rids, budgets):
        assert len(eng.results[r]) == b
        assert eng.results[r] == [int(x) for x in jeng.results[jr]], r


def test_engine_bf16_pool_of_an_f32_model_matches_jax():
    """kv_dtype='bf16' under an f32 model: both engines round K/V to bf16
    (round to nearest even) when they write the pool and attend in f32,
    so greedy tokens stay equal."""
    eng, rids, jeng, jrids, budgets = _staggered_pair("bf16", "gather")
    assert eng.pool["layers"]["k"].dtype == torch.bfloat16
    assert eng.params["embed"].dtype == torch.float32
    for jr, r, b in zip(jrids, rids, budgets):
        assert len(eng.results[r]) == b
        assert eng.results[r] == [int(x) for x in jeng.results[jr]], r


def test_engine_preemption_matches_jax():
    serve_kw = dict(page_size=4, max_active=4, max_seq=32, max_queue=32,
                    kv_dtype="f32", pages=9)      # 8 usable pages, 4 slots
    jparams, cfg, params = _f32_pair(seed=1)
    prompts = _prompts(4, cfg.vocab, seed=1)
    want = JaxServeEngine(_jax_spec(**serve_kw), params=jparams).serve(
        prompts, max_new_tokens=8)
    eng = ServeEngine(cfg, ServeConfig(**serve_kw), params, device="cpu")
    got = eng.serve(prompts, max_new_tokens=8)
    assert eng.sched.n_preempted > 0
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_engine_needs_cuda_unless_a_device_is_given(monkeypatch):
    cfg = ModelConfig(**dataclasses.asdict(
        jax_configs.get_smoke("minitron_4b")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, ServeConfig())
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(dataclasses.replace(cfg, ssm="xlstm"), ServeConfig(),
                    device="cpu")
    qk = ServeEngine(dataclasses.replace(cfg, qk_norm=True),
                     ServeConfig(page_size=4, max_seq=32), device="cpu")
    assert qk.params["layers"]["q_norm"].shape == (cfg.n_layers, cfg.hd)
    assert torch.all(qk.params["layers"]["k_norm"] == 1)
    eng = ServeEngine(cfg, ServeConfig(page_size=4, max_seq=32),
                      device="cpu")
    assert eng.pool["layers"]["k"].device.type == "cpu"
    assert eng.params["embed"].dtype == torch.bfloat16


def test_engine_sampling_is_seeded_per_request_and_position():
    cfg = ModelConfig(**dataclasses.asdict(
        jax_configs.get_smoke("minitron_4b")))
    serve = ServeConfig(page_size=4, max_seq=32, temperature=0.8, top_k=5)
    prompts = _prompts(3, cfg.vocab, seed=7)
    a = ServeEngine(cfg, serve, device="cpu", seed=3)
    out_a = a.serve(prompts, max_new_tokens=6)
    out_b = ServeEngine(cfg, serve, a.params, device="cpu", seed=3).serve(
        prompts, max_new_tokens=6)
    for rid in out_a:
        np.testing.assert_array_equal(out_a[rid], out_b[rid])
        assert out_a[rid].min() >= 0 and out_a[rid].max() < cfg.vocab
    greedy = ServeEngine(cfg, ServeConfig(page_size=4, max_seq=32), a.params,
                         device="cpu").serve(prompts, max_new_tokens=6)
    top1 = ServeEngine(cfg, dataclasses.replace(serve, top_k=1), a.params,
                       device="cpu").serve(prompts, max_new_tokens=6)
    for rid in greedy:
        np.testing.assert_array_equal(top1[rid], greedy[rid])
    assert len({sample_seed(3, r, p) for r in range(4) for p in range(4)}) \
        == 16
