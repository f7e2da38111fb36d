"""The ring and cascade backends, Table-II error injection and streaming
overlap of the port on the CPU, held against the JAX package.

The sync is integer math or f32 arithmetic in the JAX order, so it is
held bit for bit on identical buckets: the ring (its summation order and
its product with f32(1/N)), the behavioral and photonic cascades, and
Table-II injection fed JAX's own draws (the port's keys are not
threefry's, so its draws are held by their properties).  The streaming
dispatch is held to the barrier path bit for bit.  The trainer is held to
JAX's ``make_train_step`` within the train tolerance, since model sums
reorder.

The JAX references with several peers need several host devices: they
come from ONE subprocess for this module (``XLA_FLAGS`` in its
environment, never in this process), which writes an ``.npz``.
"""
import dataclasses
import functools
import io
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat  # noqa: F401  (jax API shims)
from repro.collectives import backends as jbackends
from repro.collectives import bucketizer as jbucketizer
from repro.launch import steps as jsteps
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.photonics import cascade as jcascade
from repro.photonics import error_model as jerror
from repro_torch import prng
from repro_torch.collectives import backends, bucketizer, engine
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.photonics import PhotonicsConfig, cascade, error_model
from repro_torch.photonics import runtime
from repro_torch.tree import leaves

# five trainer steps in f32 (test_torch_train.TRAIN_TOL): per-step
# differences of ~1e-6 grow through AdamW; a code may flip at an edge
TRAIN_TOL = 2e-4
NARROW = dict(name="paper-llama-narrow", family="dense", n_layers=2,
              d_model=128, n_heads=8, n_kv_heads=8, d_ff=512, vocab=512,
              dtype="float32")
SYNC_KW = dict(block=128, bucket_bytes=4096)
# 4000 elements: 3 full buckets of 1024 and a ragged tail of 928
SIZE = 4000
# Table-II injection hits 1.1e-4 of the codes at most, so its cases run
# 4 buckets of 65536 elements: ~28 hits a step on either path
BIG = 1 << 18
BIG_KW = dict(block=128, bucket_bytes=BIG)
# ring peer grids (pods, dp): N 2, 3 and 4, and 2 pods of 2
RING = {"n2": (1, 2), "n3": (1, 3), "n4": (1, 4), "p2x2": (2, 2)}
# (mode, bits, error_feedback, fidelity, pods, dp, error_layers, inputs)
SYNC_CASES = {
    "cascade8": ("cascade", 8, False, "behavioral", 2, 2, (), "small"),
    "cascade8_ef": ("cascade", 8, True, "behavioral", 2, 2, (), "small"),
    "cascade2_ef": ("cascade", 2, True, "behavioral", 2, 2, (), "small"),
    "cascade2": ("cascade", 2, False, "behavioral", 2, 2, (), "small"),
    "cascade_onn2_ef": ("cascade", 2, True, "onn", 2, 2, (), "small"),
    "cascade_mesh2": ("cascade", 2, False, "mesh", 2, 2, (), "small"),
    "ring_p2x2_ef": ("ring", 8, True, "behavioral", 2, 2, (), "small"),
    "inj_optinc8": ("optinc", 8, False, "behavioral", 1, 4, (3, 4, 5, 6),
                    "big"),
    "inj_cascade8_ef": ("cascade", 8, True, "behavioral", 2, 2,
                        (3, 4, 5, 6), "big"),
    "inj_onn2": ("optinc", 2, False, "onn", 1, 4, (3, 4, 5, 6), "big"),
    "inj_cascade_onn2": ("cascade", 2, False, "onn", 2, 2, (3, 4, 5, 6),
                         "big"),
}
# narrow trainer runs against JAX make_train_step: (argv, pods, dp)
TRAIN_CASES = {
    "ring": (["--sync", "ring", "--mesh", "2x1"], 1, 2),
    "cascade": (["--sync", "cascade", "--pods", "2", "--mesh", "1x1"], 2, 1),
    "overlap": (["--sync", "optinc", "--mesh", "2x1", "--overlap"], 1, 2),
}
TRAIN_STEPS = 4


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs():
    rng = np.random.default_rng(25)
    out = {"bucket": rng.normal(size=(4, 1001)).astype(np.float32)}
    for step in (1, 2):
        flat = rng.normal(size=(4, SIZE)).astype(np.float32)
        flat[:, 1280:1408] = 0.0                     # a zero block
        flat[:, :3] = [[1.0, 0.5, -0.5]] * 4         # exact ties at bits 2
        out[f"small_a{step}"] = flat[:, :2100].reshape(4, 3, 700)
        out[f"small_b{step}"] = flat[:, 2100:3600]
        out[f"small_d{step}"] = flat[:, 3600:].reshape(4, 40, 10)
        big = rng.normal(size=(4, BIG)).astype(np.float32)
        out[f"big_a{step}"] = big[:, :1000].reshape(4, 10, 100)
        out[f"big_b{step}"] = big[:, 1000:BIG - 7]
        out[f"big_d{step}"] = big[:, BIG - 7:].reshape(4, 7, 1)
    return out


def _tree(inputs, which, step, n):
    return {"a": _t(inputs[f"{which}_a{step}"][:n]),
            "b": _t(inputs[f"{which}_b{step}"][:n]),
            "c": {"d": _t(inputs[f"{which}_d{step}"][:n])}}


def _cat(synced):
    return torch.cat([synced["a"].reshape(-1), synced["b"].reshape(-1),
                      synced["c"]["d"].reshape(-1)]).numpy()


JAX_SCRIPT = textwrap.dedent("""
    import json, math, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from repro import compat  # noqa: F401
    from repro.api import MeshSpec
    from repro.collectives import SyncConfig, sync_gradients
    from repro.collectives import backends as jb
    from repro.collectives.bucketizer import make_layout
    from repro.data import pipeline as jdata
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import layers as jl
    from repro.models import lm as jlm
    from repro.models.config import ModelConfig
    from repro.optim import adamw as jadamw
    from repro.photonics import PhotonicsConfig, error_model

    inp = np.load(sys.argv[1])
    spec = json.loads(sys.argv[3])
    out = {}

    def grid(pods, dp):
        if pods > 1:
            return make_mesh((pods, dp), ("pod", "data")), ("pod", "data")
        return make_mesh((dp,), ("data",)), ("data",)

    for name, (pods, dp) in spec["ring"].items():
        n = pods * dp
        mesh, axes = grid(pods, dp)
        cfg = SyncConfig(mode="ring", axes=axes)
        f = jax.jit(jax.shard_map(
            lambda x: jb.RingBackend().sync(x[0], cfg, None)[0][None],
            mesh=mesh, in_specs=P(axes), out_specs=P(axes),
            check_vma=False))
        out["ring/" + name] = np.asarray(f(jnp.asarray(inp["bucket"][:n])))

    for name, c in spec["sync"].items():
        mode, bits, ef, fid, pods, dp, layers, which = c
        n = pods * dp
        mesh, axes = grid(pods, dp)
        kw = spec["big_kw"] if which == "big" else spec["small_kw"]
        cfg = SyncConfig(mode=mode, axes=axes, bits=bits, error_feedback=ef,
                         error_layers=tuple(layers),
                         photonics=PhotonicsConfig(fidelity=fid), **kw)
        size = sum(int(np.prod(inp[f"{which}_{k}1"].shape[1:]))
                   for k in "abd")

        def f(a, b, d, res, key):
            tree = {"a": a[0], "b": b[0], "c": {"d": d[0]}}
            s, r = sync_gradients(tree, cfg, key, res[0] if ef else None)
            r = res[0] * 0 if r is None else r
            return s["a"][None], s["b"][None], s["c"]["d"][None], r[None]

        fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(axes),) * 4
                                   + (P(),), out_specs=P(axes),
                                   check_vma=False))
        res = jnp.zeros((n, size), jnp.float32)
        layout = make_layout([jnp.zeros(size)], kw["bucket_bytes"])
        for step in (1, 2):
            key = jax.random.PRNGKey(100 + step)
            args = [jnp.asarray(inp[f"{which}_{k}{step}"][:n]) for k in "abd"]
            a, b, d, res = fn(*args, res, key)
            k = f"{name}/{step}"
            out[k + "/synced"] = np.concatenate(
                [np.asarray(x).reshape(n, -1) for x in (a, b, d)], 1)
            out[k + "/residual"] = np.asarray(res)
            if not layers:
                continue
            es = error_model.TABLE_II[tuple(layers)]
            keys = jax.random.split(key, layout.n_buckets)
            for bi, (s, e) in enumerate(layout.bounds):
                width = -(-(e - s) // kw["block"]) * kw["block"]
                shape = (-(-width // n),) if fid == "behavioral" else (width,)
                k1, k2 = jax.random.split(keys[bi])
                out[f"{k}/hit{bi}"] = np.asarray(
                    jax.random.bernoulli(k1, es.p_error, shape))
                out[f"{k}/which{bi}"] = np.asarray(jax.random.categorical(
                    k2, jnp.log(jnp.asarray(es.ratios, jnp.float32)),
                    shape=shape))

    # the photonic cascade refuses bits 8
    try:
        cfg = SyncConfig(mode="cascade", axes=("pod", "data"), bits=8,
                         photonics=PhotonicsConfig(fidelity="onn"))
        mesh, axes = grid(2, 2)
        jax.jit(jax.shard_map(lambda x: jb.CascadeBackend().sync(
            x[0], cfg, None)[0][None], mesh=mesh, in_specs=P(axes),
            out_specs=P(axes), check_vma=False))(
                jnp.asarray(inp["bucket"][:4]))
        out["cascade_bits8_raises"] = np.array(False)
    except ValueError as e:
        out["cascade_bits8_raises"] = np.array("bits <= 2" in str(e))

    cfg = ModelConfig(**spec["narrow"])

    # the batch rows each device of a (pod, data, model) mesh takes
    ms = MeshSpec(dp=2, pods=2)
    ctx = ms.ctx()
    tok = jnp.arange(8 * 3, dtype=jnp.int32).reshape(8, 3)
    rows = jax.jit(jax.shard_map(
        lambda b: jnp.stack([b["tokens"][:, 0],
                             jnp.full((2,), lax.axis_index("pod")),
                             jnp.full((2,), lax.axis_index("data"))])[None],
        mesh=ms.build(), in_specs=(jsteps.batch_specs(ctx, cfg),),
        out_specs=P(ctx.dp_axes), check_vma=False))({"tokens": tok})
    out["batch_rows"] = np.asarray(rows)

    # narrow trainer steps
    params0 = jlm.init_params(cfg, jl.ShardCtx(), jax.random.PRNGKey(1))
    data = jdata.SyntheticLM(jdata.DataConfig(vocab=cfg.vocab, seq_len=32,
                                              global_batch=4, seed=0))
    for name, (mode, pods, dp, overlap) in spec["train"].items():
        mesh = MeshSpec(dp=dp, pods=pods).build()
        axes = ("pod", "data") if pods > 1 else ("data",)
        sync = SyncConfig(mode=mode, axes=axes, bits=8, block=128,
                          error_feedback=True, bucket_bytes=2 ** 18,
                          overlap=overlap)
        opt = jadamw.AdamWConfig(lr=1e-3)
        fn, _, _ = jsteps.make_train_step(cfg, mesh, sync, opt)
        fn = jax.jit(fn)
        params, ostate = params0, jadamw.adamw_init(opt, params0)
        sstate = jsteps.init_sync_state(cfg, mesh, sync)
        losses = []
        with jax.set_mesh(mesh):
            for i in range(spec["steps"]):
                params, ostate, sstate, m = fn(
                    params, ostate, sstate,
                    {"tokens": jnp.asarray(data.batch(i))},
                    jax.random.PRNGKey(i))
                losses.append(float(m["loss"]))
        out["train/" + name] = np.array(losses)
    np.savez(sys.argv[2], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every JAX reference of this module from one subprocess with four
    host devices."""
    from conftest import subprocess_env
    d = tmp_path_factory.mktemp("jax_sync_modes")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    spec = {"ring": RING, "sync": SYNC_CASES, "small_kw": SYNC_KW,
            "big_kw": BIG_KW, "narrow": NARROW, "steps": TRAIN_STEPS,
            "train": {"ring": ("ring", 1, 2, False),
                      "cascade": ("cascade", 2, 1, False),
                      "overlap": ("optinc", 1, 2, True)}}
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(spec)],
        capture_output=True, text=True, timeout=900,
        env=subprocess_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert r.returncode == 0, r.stderr[-3000:]
    return inputs, dict(np.load(d / "out.npz"))


# ------------------------------------------------------------- cascade
def test_cascade_numpy_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((4, 4, 33), (2, 3, 7), (4, 1, 5)):
        u = rng.integers(0, 255, shape)
        for fn in ("expected", "basic_cascade", "carry_cascade"):
            np.testing.assert_array_equal(getattr(cascade, fn)(u),
                                          getattr(jcascade, fn)(u))
        np.testing.assert_array_equal(cascade.carry_cascade(u),
                                      cascade.expected(u))
    for n in range(1, 70):
        assert cascade.extra_symbols(n) == jcascade.extra_symbols(n)
    base = (4, 64, 128, 256, 128, 64, 4)
    for approx in ((1, 2, 3, 4, 5, 6), (2, 3), ()):
        assert cascade.hardware_overhead(base, approx) == \
            jcascade.hardware_overhead(base, approx)
    cc, jc = cascade.CascadeConfig(), jcascade.CascadeConfig()
    assert cc.expanded_structure(base) == jc.expanded_structure(base)
    assert cc.expanded_approx_layers(base) == jc.expanded_approx_layers(base)


# ---------------------------------------------------------------- ring
@pytest.mark.parametrize("name", list(RING))
def test_ring_matches_jax_bit_for_bit(jax_ref, name):
    """The ring's f32 summation order and its product with f32(1/N),
    over one axis and over ('pod', 'data')."""
    inputs, ref = jax_ref
    pods, dp = RING[name]
    n = pods * dp
    cfg = engine.SyncConfig(mode="ring",
                            axes=("pod", "data") if pods > 1 else ("data",))
    x = engine.peer_view(_t(inputs["bucket"][:n]), cfg, pods)
    got, err = backends.RingBackend().sync(x, cfg)
    want = ref["ring/" + name]
    assert err is None and (want == want[0]).all()
    np.testing.assert_array_equal(got.numpy(), want[0])
    # a plain f32 sum of the peers is not the ring's order
    plain = (x.reshape(n, -1).sum(0) * float(np.float32(1) / n)).numpy()
    assert n < 3 or (plain != want[0]).any()


@pytest.mark.parametrize("name", ["ring", "cascade"])
def test_wire_models_match_jax(name):
    port = backends.RingBackend() if name == "ring" else \
        backends.CascadeBackend()
    jax_b = jbackends.RingBackend() if name == "ring" else \
        jbackends.CascadeBackend()
    for nbytes in (1e3, 8.7e7):
        for n in (2, 4, 16):
            kws = [{}] if name == "ring" else [{}, {"n1": 2}, {"n1": n},
                                                {"n1": 4}]
            for kw in kws:
                assert port.bytes_on_wire(nbytes, n, 8, **kw) == \
                    jax_b.bytes_on_wire(nbytes, n, 8, **kw)
                for overlap in (False, True):
                    assert port.time_on_wire(nbytes, n, 8, overlap,
                                             **kw) == \
                        jax_b.time_on_wire(nbytes, n, 8, overlap, **kw)


# ------------------------------------------- cascade and injection sync
class _JaxDraws:
    """``error_model.draws`` replaced by JAX's draws of one step, bucket
    by bucket in the barrier order."""

    def __init__(self, ref, key, n_buckets):
        self.queue = [(ref[f"{key}/hit{b}"], ref[f"{key}/which{b}"])
                      for b in range(n_buckets)]
        self.shapes = []

    def __call__(self, key, shape, spec, device="cpu"):
        hit, which = self.queue.pop(0)
        assert tuple(shape) == hit.shape
        self.shapes.append(tuple(shape))
        return _t(hit), _t(which)


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_matches_jax_shard_map(jax_ref, case, monkeypatch):
    """cascade (behavioral and through the bits-2 exact identity ONN),
    ring over pods, and Table-II injection on JAX's draws against JAX's
    sync_gradients under shard_map, two steps, bit for bit; the cascade
    also equal to optinc over the same peers."""
    inputs, ref = jax_ref
    mode, bits, ef, fid, pods, dp, layers, which = SYNC_CASES[case]
    monkeypatch.setattr(runtime, "_CACHE", {})
    n = pods * dp
    kw = BIG_KW if which == "big" else SYNC_KW
    cfg = engine.SyncConfig(
        mode=mode, axes=("pod", "data") if pods > 1 else ("data",),
        bits=bits, error_feedback=ef, error_layers=layers,
        photonics=PhotonicsConfig(fidelity=fid), **kw)
    size = sum(int(np.prod(inputs[f"{which}_{k}1"].shape[1:]))
               for k in "abd")
    nb = bucketizer.expected_buckets(4 * size, kw["bucket_bytes"])
    res = torch.zeros((n, size)) if ef else None
    hits = 0
    for step in (1, 2):
        grads = _tree(inputs, which, step, n)
        key = f"{case}/{step}"
        if layers:
            draws = _JaxDraws(ref, key, nb)
            monkeypatch.setattr(error_model, "draws", draws)
            hits += sum(ref[f"{key}/hit{b}"].sum() for b in range(nb))
        synced, new_res = engine.sync_gradients(grads, cfg, res,
                                                key=prng.PRNGKey(step),
                                                pods=pods)
        got = _cat(synced)
        want = ref[key + "/synced"]
        assert (want == want[0]).all()
        np.testing.assert_array_equal(got, want[0])
        if layers:
            assert not draws.queue        # one draw a bucket
            # behavioral: a draw of ceil(L / N) codes for N shards
            if fid == "behavioral":
                assert draws.shapes[0] == (BIG // 4 // n,)
        if ef and mode != "ring":
            np.testing.assert_array_equal(new_res.numpy(),
                                          ref[key + "/residual"])
            assert new_res.abs().max() > 0
        elif not ef:
            assert new_res is None
        if mode == "cascade" and not layers:
            flat_cfg = dataclasses.replace(cfg, mode="optinc", axes=("data",),
                                           photonics=PhotonicsConfig())
            opt, opt_res = engine.sync_gradients(grads, flat_cfg, res)
            np.testing.assert_array_equal(got, _cat(opt))
            if ef:
                assert torch.equal(new_res, opt_res)
        res = new_res
    if layers:
        assert hits > 0                      # the case injected something


def test_photonic_cascade_refuses_bits_8(jax_ref):
    _, ref = jax_ref
    assert bool(ref["cascade_bits8_raises"])
    cfg = engine.SyncConfig(mode="cascade", axes=("pod", "data"), bits=8,
                            photonics=PhotonicsConfig(fidelity="onn"))
    with pytest.raises(ValueError, match="bits <= 2"):
        backends.CascadeBackend().sync(torch.zeros((2, 2, 256)), cfg)


def test_peer_order_is_jax_pod_major(jax_ref):
    """Device (pod, d) of JAX's (pod, data, model) mesh takes batch rows
    [p B/N, (p+1) B/N) with p = pod * dp + d, the port's peer p."""
    _, ref = jax_ref
    rows = ref["batch_rows"]                 # (N, 3, B / N)
    for p in range(4):
        np.testing.assert_array_equal(rows[p, 0], [6 * p, 6 * p + 3])
        assert (rows[p, 1] == p // 2).all() and (rows[p, 2] == p % 2).all()


# ------------------------------------------------------------ injection
@pytest.mark.parametrize("layers", sorted(jerror.TABLE_II))
def test_inject_with_matches_jax_on_jax_draws(layers):
    spec, jspec = error_model.TABLE_II[layers], jerror.TABLE_II[layers]
    assert (spec.accuracy, spec.values, spec.ratios) == \
        (jspec.accuracy, jspec.values, jspec.ratios)
    rng = np.random.default_rng(sum(layers))
    u = rng.integers(0, 2 ** 16 - 1, 50000).astype(np.int32)
    u[:50] = 0
    u[50:100] = 2 ** 16 - 2                  # clipped at both ends
    key = jax.random.PRNGKey(len(layers))
    want = np.asarray(jax.jit(lambda k, x: jerror.inject(k, x, jspec, 16))(
        key, jnp.asarray(u)))
    if not spec.values:
        assert torch.equal(error_model.inject(prng.PRNGKey(0), _t(u), spec,
                                              16), _t(u))
        np.testing.assert_array_equal(want, u)
        return
    k1, k2 = jax.random.split(key)
    hit = np.asarray(jax.random.bernoulli(k1, spec.p_error, u.shape))
    which = np.asarray(jax.random.categorical(
        k2, jnp.log(jnp.asarray(spec.ratios, jnp.float32)), shape=u.shape))
    got = error_model.inject_with(_t(u), _t(hit), _t(which), spec, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the row's own p hits a few codes in 50000: the arithmetic again
    # on a draw that hits 30% of them
    dense = np.asarray(jax.random.bernoulli(k1, 0.3, u.shape))
    got = error_model.inject_with(_t(u), _t(dense), _t(which), spec, 16)
    exp = np.clip(u + np.where(dense, np.asarray(spec.values)[which], 0), 0,
                  2 ** 16 - 2)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_injection_repeats_one_draw_on_every_shard():
    """The behavioral path injects one draw of ceil(L / N) codes into
    each of the N shards: the same positions and values in every shard
    (where no clip intervenes)."""
    spec = error_model.TABLE_II[(3, 4, 5, 6)]
    cfg = engine.SyncConfig(bits=16, error_layers=(3, 4, 5, 6))
    u = torch.full((4 * 5000 - 3,), 30000, dtype=torch.int32)
    hit = torch.zeros(5000, dtype=torch.bool)
    hit[[0, 17, 4999]] = True
    which = torch.tensor([0, 1, 2, 3, 4] * 1000)
    orig = error_model.draws
    try:
        error_model.draws = lambda k, shape, s, d="cpu": (hit, which)
        got = backends._inject(u, spec, cfg, 7, 4)
    finally:
        error_model.draws = orig
    diff = torch.nn.functional.pad(got - u, (0, 3)).view(4, 5000)
    assert (diff[:3] == diff[0]).all()
    assert diff[0].nonzero().flatten().tolist() == [0, 17, 4999]
    assert diff[0, [0, 17, 4999]].tolist() == [1, 1024, -4]
    assert got.numel() == u.numel()


@pytest.mark.parametrize("layers", [k for k, v in error_model.TABLE_II.items()
                                    if v.values])
def test_port_draws_have_the_table_ii_rates(layers):
    """The port's own draws, by their properties: the hit rate and the
    value ratios within 5 binomial sigma, the same key gives the same
    codes and another key others."""
    spec = error_model.TABLE_II[layers]
    n = 1 << 22
    hit, which = error_model.draws(prng.PRNGKey(9), (n,), spec)
    mean = n * spec.p_error
    assert abs(hit.sum().item() - mean) <= 5 * (mean ** 0.5) + 1
    counts = torch.bincount(which, minlength=len(spec.values))
    for k, r in enumerate(spec.ratios):
        sd = (n * r * (1 - r)) ** 0.5
        assert abs(counts[k].item() - n * r) <= 5 * sd + 1
    u = torch.full((1 << 20,), 100, dtype=torch.int32)
    a = error_model.inject(prng.PRNGKey(3), u, spec, 8)
    assert torch.equal(a, error_model.inject(prng.PRNGKey(3), u, spec, 8))
    if spec.p_error * u.numel() > 20:
        assert not torch.equal(
            a, error_model.inject(prng.PRNGKey(4), u, spec, 8))
        assert int((a != u).sum()) > 0
    assert int(a.min()) >= 0 and int(a.max()) <= 254


# ---------------------------------------------- bucketizer and readiness
@pytest.mark.parametrize("seed", range(4))
def test_streaming_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    shapes = [tuple(int(x) for x in rng.integers(0, 40, rng.integers(1, 3)))
              for _ in range(int(rng.integers(1, 12)))]
    bucket_bytes = int(rng.integers(1, 400)) * 4 + int(seed == 3)
    jl_ = jbucketizer.make_layout(
        [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes], bucket_bytes)
    tl = bucketizer.make_layout([(s, torch.float32) for s in shapes],
                                bucket_bytes)
    assert tl.bounds == jl_.bounds
    assert bucketizer.bucket_segments(tl) == jbucketizer.bucket_segments(jl_)
    assert bucketizer.leaf_segments(tl) == jbucketizer.leaf_segments(jl_)
    n = len(shapes)
    for ready in (None, tuple(int(x) for x in rng.permutation(n)),
                  tsteps.grad_readiness(range(n), n),
                  tuple(int(x) for x in rng.integers(0, 3, n))):
        want = jbucketizer.launch_order(jl_, ready)
        assert bucketizer.launch_order(tl, ready) == want
        # a BucketStream told of the leaves in emission order launches
        # the buckets in launch_order, ties included
        stream = engine.BucketStream(tl, engine.SyncConfig(mode="psum"),
                                     torch.zeros((2, tl.total)))
        for i in bucketizer.emission_order(tl, ready):
            stream.leaf_ready(i)
        stream.finish()
        assert tuple(stream.order) == want
    idx = sorted(rng.choice(n + 3, size=min(n, 4), replace=False).tolist())
    assert tsteps.grad_readiness(idx, n + 3) == \
        jsteps.grad_readiness(idx, n + 3)
    with pytest.raises(ValueError, match="rank every leaf"):
        bucketizer.launch_order(tl, (0,) * (n + 1))


# ------------------------------------------------ streaming vs barrier
STREAM_CASES = {
    "optinc8_ef": dict(mode="optinc", bits=8, error_feedback=True),
    "cascade2_ef": dict(mode="cascade", bits=2, error_feedback=True),
    "ring": dict(mode="ring"),
    "mesh2_shot_noise": dict(mode="optinc", bits=2, photonics=PhotonicsConfig(
        fidelity="mesh", shot_noise_std=0.05)),
    "inject8_ef": dict(mode="optinc", bits=8, error_feedback=True,
                       error_layers=(3, 4, 5, 6)),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streaming_is_the_barrier_path_bit_for_bit(case, monkeypatch):
    """``sync_gradients`` with overlap (the default readiness, then a
    random one) against overlap off, and a ``BucketStream`` fed its
    leaves in a random order, two steps with a sync key (noise and
    injection draw from it) and error feedback."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    kw = STREAM_CASES[case]
    pods = 2 if kw["mode"] in ("cascade", "ring") else 1
    axes = ("pod", "data") if pods > 1 else ("data",)
    cfg = engine.SyncConfig(axes=axes, **SYNC_KW, **kw)
    on = dataclasses.replace(cfg, overlap=True)
    inputs = _inputs()
    rng = np.random.default_rng(1)
    ef = cfg.error_feedback
    res = res_on = res_stream = torch.zeros((4, SIZE)) if ef else None
    for step in (1, 2):
        grads = _tree(inputs, "small", step, 4)
        key = prng.fold_in(prng.PRNGKey(5), step)
        want, res = engine.sync_gradients(grads, cfg, res, key, pods=pods)
        ready = None if step == 1 else tuple(int(x) for x in
                                             rng.permutation(3))
        got, res_on = engine.sync_gradients(grads, on, res_on, key,
                                            readiness=ready, pods=pods)
        np.testing.assert_array_equal(_cat(got), _cat(want))
        leaves = [grads["a"], grads["b"], grads["c"]["d"]]
        layout = bucketizer.make_layout(
            [(l.shape[1:], l.dtype) for l in leaves], cfg.bucket_bytes)
        flat = torch.empty((4, SIZE))
        stream = engine.BucketStream(layout, on, flat, res_stream, key, pods)
        off = [0, 2100, 3600]
        for i in rng.permutation(3):
            flat[:, off[i]:off[i] + leaves[i][0].numel()] = \
                leaves[i].reshape(4, -1)
            stream.leaf_ready(int(i))
        synced, res_stream = stream.finish()
        np.testing.assert_array_equal(synced.numpy(), _cat(want))
        assert sorted(stream.order) == list(range(layout.n_buckets))
        if ef:
            assert torch.equal(res_on, res) and torch.equal(res_stream, res)
    with pytest.raises(RuntimeError, match="never launched"):
        engine.BucketStream(layout, on, flat).finish()


def test_trainer_overlap_launches_buckets_during_the_backward():
    """The trainer's hooks: every bucket launched once, all but those of
    the last leaf the backward produces before it ended, and the same
    losses and parameters as the barrier trainer, bit for bit."""
    cfg = ModelConfig(**NARROW)
    opt = tadamw.AdamWConfig(lr=1e-3)
    data = tdata.SyntheticLM(tdata.DataConfig(vocab=cfg.vocab, seq_len=32,
                                              global_batch=4, seed=0))
    runs = {}
    for overlap in (False, True):
        sync = engine.SyncConfig(mode="optinc", bits=8, block=128,
                                 error_feedback=True, bucket_bytes=2 ** 16,
                                 overlap=overlap)
        step = tsteps.make_train_step(cfg, 2, sync, opt, "cpu")
        params = tlm.init_params(cfg, 0, "cpu")
        ostate = tadamw.adamw_init(opt, params)
        sstate = tsteps.init_sync_state(cfg, 2, sync, "cpu")
        losses = []
        for i in range(3):
            params, ostate, sstate, m = step(
                params, ostate, sstate, torch.from_numpy(data.batch(i)),
                prng.PRNGKey(i))
            losses.append(m["loss"].item())
        runs[overlap] = losses, params, sstate, step.last_stream
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[True][1]),
                                                 leaves(runs[False][1])))
    assert torch.equal(runs[True][2]["rep"], runs[False][2]["rep"])
    stream = runs[True][3]
    nb = stream.layout.n_buckets
    assert sorted(stream.order) == list(range(nb)) and nb > 4
    assert 0 < stream.early < nb
    assert runs[False][3] is None


# -------------------------------------------------------------- trainer
@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg = JaxModelConfig(**NARROW)
    return jlm.init_params(jcfg, jl.ShardCtx(), jax.random.PRNGKey(1))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_matches_jax_make_train_step(jax_ref, case):
    """The port's trainer (narrow f32, error feedback, 0.25 MiB buckets)
    against JAX's make_train_step on the same peer grid, TRAIN_STEPS
    steps from the same weights and tokens."""
    _, ref = jax_ref
    argv, pods, dp = TRAIN_CASES[case]
    cfg = ModelConfig(**NARROW)
    params = tlm.params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                                 cfg, device="cpu")
    opts = train.parse_args(
        ["--device", "cpu", *argv, "--steps", str(TRAIN_STEPS), "--lr",
         "1e-3", "--global-batch", "4", "--seq-len", "32", "--bucket-mb",
         "0.25", "--block", "128", "--error-feedback", "--bits", "8"])
    assert (opts.spec.mesh.pods, opts.spec.mesh.dp) == (pods, dp)
    recs = train.run(opts, params=params, cfg=cfg, out=io.StringIO())
    got = [r["loss"] for r in recs]
    np.testing.assert_allclose(got, ref["train/" + case], rtol=0,
                               atol=TRAIN_TOL)
    assert got[-1] < got[0]
