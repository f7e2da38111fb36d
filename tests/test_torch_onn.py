"""The port's in-network ONN on the CPU (``repro_torch.photonics`` and the
``onn_layer`` kernel's plain version), held against the JAX package on
the same numpy-seeded inputs.

The symbol-level encoding is integer math and is held bit for bit.  The
dense ONN sums f32 products in another order than XLA, so its analog
outputs are held to a stated tolerance, and its PAM4 decisions are held
equal wherever JAX's analog output is not within a margin of a decision
threshold.  The JAX side of the ONN is held jitted, as the collective
runs it (XLA multiplies by the f32 reciprocal where the code divides by
a constant).  Nothing here builds or launches CUDA.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import onn_layer as jonn_k
from repro.photonics import config as jconfig
from repro.photonics import encoding as jenc
from repro.photonics import onn as jonn
from repro.photonics import pipeline as jpipe
from repro.photonics import runtime as jruntime
from repro.photonics.module import ONNModule as JaxONNModule
from repro_torch.kernels import onn_layer, ref
from repro_torch.photonics import area, config, encoding, onn, pipeline
from repro_torch.photonics import runtime
from repro_torch.photonics.module import ONNModule

ROOT = Path(__file__).resolve().parents[1]
# onn_layer, plain vs the Pallas kernel in interpret mode: both sum n f32
# products, in other orders; a few ulp of the largest output
LAYER_RTOL = 1e-5
# the whole ONN (6 layers, widths to 256), port vs jitted JAX: reordered
# f32 sums through every layer, relative to the largest output
ONN_RTOL = 1e-5
# PAM4 decisions are compared where JAX's analog output is farther than
# this from a decision threshold k + 0.5 (the analog outputs agree to
# ~1e-6 here)
THRESHOLD_MARGIN = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def clean_cache(monkeypatch):
    """Each runtime's module cache, empty for the test and restored
    after."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    monkeypatch.setattr(jruntime, "_CACHE", {})


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ onn_layer
SHAPES = [(128, 128, 128), (256, 128, 256), (128, 256, 384),
          (384, 512, 128),                       # tests/test_kernels.py
          (1000, 64, 4), (1000, 4, 1), (1000, 1, 4)]   # ragged: (rows, m, n)


def _layer_case(rows, m, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(max(m, n), max(m, n))))
    u = q[:m, :n].astype(np.float32)
    d = rng.normal(size=(m,)).astype(np.float32)
    b = rng.normal(size=(m,)).astype(np.float32)
    return x, u, d, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("rows,m,n", SHAPES)
def test_onn_layer_matches_the_jax_pallas_kernel(rows, m, n, relu):
    x, u, d, b = _layer_case(rows, m, n, rows + m + n)
    # 8-row batch tiles: the Pallas kernel wants tiles that divide rows
    want = np.asarray(jonn_k.onn_layer(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(d), jnp.asarray(b),
        relu=relu, blk_b=128 if rows % 128 == 0 else 8, interpret=True))
    got = ref.onn_layer_ref(_t(x), _t(u), _t(d), _t(b), relu)
    assert got.dtype == torch.float32 and got.shape == (rows, m)
    tol = LAYER_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    before = onn_layer.onn_layer.launches
    assert torch.equal(onn_layer.onn_layer(_t(x), _t(u), _t(d), _t(b), relu),
                       got)
    assert onn_layer.onn_layer.launches == before      # CPU: the plain path


def test_onn_layer_wrapper_rejects_bad_input():
    x, u, d, b = (_t(a) for a in _layer_case(10, 4, 3, 0))
    with pytest.raises(TypeError, match="float32"):
        onn_layer.onn_layer(x.double(), u, d, b)
    with pytest.raises(TypeError, match="float32"):
        onn_layer.onn_layer(x, u, d, b.half())
    with pytest.raises(ValueError, match=r"x \(rows, n\)"):
        onn_layer.onn_layer(x, u.T.contiguous(), d, b)
    with pytest.raises(ValueError, match=r"x \(rows, n\)"):
        onn_layer.onn_layer(x[None], u, d, b)
    with pytest.raises(ValueError, match=r"x \(rows, n\)"):
        onn_layer.onn_layer(x[:, :0], u[:, :0], d, b)
    with pytest.raises(ValueError, match="d and b"):
        onn_layer.onn_layer(x, u, d[:2], b)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        onn_layer.onn_layer(x, u.to("meta"), d, b)


# ------------------------------------------------------- onn_layer plan
# Every layer of the ONN structures the port runs, and the form the plan
# must give it with x and y 16-byte aligned.  n 512 and 1024: W's panel
# of 64 columns does not fit in shared memory beside the ring.
TABLE_I = [(4, 64, 128, 256, 128, 64, 4),
           (4, 64, 128, 256, 512, 256, 128, 64, 4),
           (4, 64, 128, 256, 512, 1024, 512, 256, 128, 64, 4),
           (4, 64, 128, 256, 512, 256, 128, 64, 8)]
STRUCTURES = ([runtime.default_structure(bits, k) for bits in (2, 4, 8)
               for k in (1, 2, 3, 4)] + TABLE_I)
WANT_FORM = {
    (1, 4): "fan_out", (1, 64): "fan_out", (2, 64): "fan_out",
    (3, 64): "fan_out", (4, 64): "fan_out",
    (4, 1): "fan_out", (64, 2): "fan_in", (64, 4): "fan_in",
    (64, 8): "fan_in",
    (64, 128): "wide", (128, 256): "wide", (256, 128): "wide",
    (128, 64): "wide", (256, 512): "wide", (512, 256): "general",
    (512, 1024): "general", (1024, 512): "general"}
# W's panel columns of the wide layers: 128 above 64 columns, else 64
WANT_PANEL = {(64, 128): 128, (128, 256): 128, (256, 128): 128,
              (128, 64): 64, (256, 512): 128}


@pytest.mark.parametrize("structure", STRUCTURES, ids=str)
def test_onn_layer_plan_gives_each_layer_its_form(structure):
    for n, m in zip(structure[:-1], structure[1:]):
        for rows in (1, 1000, 2 ** 20, 2 ** 26):
            p = onn_layer.plan(rows, n, m, 1 << 20, 2 << 20)
            assert p.form == WANT_FORM[(n, m)], (n, m)
            assert 0 <= p.smem <= onn_layer.SMEM_MAX
            assert 1 <= p.grid[0] <= onn_layer.GRID_X_MAX
            assert 1 <= p.grid[1] <= onn_layer.GRID_Y_MAX
            assert 1 <= p.threads <= onn_layer.THREADS
            if p.form == "wide":
                assert p.tile == WANT_PANEL[(n, m)]
                assert p.smem == onn_layer.wide_smem(n, p.tile)
                # persistent: at most one block a multiprocessor
                assert p.grid[0] * p.grid[1] <= max(onn_layer.H100_SMS,
                                                    p.grid[1])
            elif p.form == "fan_in":
                assert p.smem == onn_layer.fan_in_smem(n, m, p.tile)
            elif p.form == "fan_out":
                assert p.tile == (4 if m % 4 == 0 else 1)
                assert p.threads % (m // p.tile) == 0


@pytest.mark.parametrize("n,m,x_off,y_off,want,tile", [
    (37, 300, 0, 0, "general", 128),    # n not a multiple of 4
    (36, 30, 0, 0, "general", 128),     # m not a multiple of 4
    (128, 256, 4, 0, "general", 128),   # x off the 16-byte alignment
    (128, 256, 0, 8, "general", 128),   # y off it
    (64, 4, 12, 0, "general", 256),     # fan-in reads x in 16-byte pieces
    (3, 301, 0, 0, "general", 128),     # too many columns of one
    (4, 64, 0, 4, "fan_out", 1),        # y off: a column a thread
    (3, 6, 0, 0, "fan_out", 1),
    (4, 64, 4, 0, "fan_out", 4),        # fan-out reads x by the word
    (64, 4, 0, 4, "fan_in", 256 // 4),  # fan-in stores y by the word
    (36, 300, 0, 0, "wide", 128),       # a partial k chunk, masked
    (100, 12, 0, 0, "wide", 64)])       # columns
def test_onn_layer_plan_sends_odd_shapes_and_views_to_general(
        n, m, x_off, y_off, want, tile):
    p = onn_layer.plan(1000, n, m, 4096 + x_off, 8192 + y_off)
    assert (p.form, p.tile) == (want, tile)
    if want == "general":
        assert p == onn_layer.general_plan(1000, m)
        assert p.grid == (-(-1000 // p.tile), -(-m // (
            4 if m <= 8 else 64 if m <= 64 else 128)))


def _ring_walk(p, rows, n, stages):
    """A Python copy of the persistent blocks' loops in csrc/onn_layer.cu
    (the loader's and the consumer's counters, one barrier an iteration):
    the (row tile, column tile, k chunk) each block computes, in order,
    after checking that every chunk it reads is the one its stage was
    last loaded with, and that no load overwrites a stage not yet
    read."""
    bm = onn_layer.wide_rows(p.tile) if p.form == "wide" else p.tile
    nk = -(-n // onn_layer.WIDE_BK) if p.form == "wide" else 1
    tiles = -(-rows // bm)
    seen = []
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            slots = [None] * stages        # what each stage holds
            read = [True] * stages         # read since it was loaded
            ld = [bx, 0, 0]                # the loader's tile, chunk, stage

            def load_next():
                t, k, s = ld
                if t < tiles:
                    assert read[s], "a load overwrote an unread stage"
                    slots[s], read[s] = (t, k), False
                ld[1] += 1
                if ld[1] == nk:
                    ld[0], ld[1] = t + p.grid[0], 0
                ld[2] = (s + 1) % stages

            for _ in range(stages - 1):
                load_next()
            t, kc, stage = bx, 0, 0
            while t < tiles:
                load_next()        # after the barrier: stage - 1 is read
                assert slots[stage] == (t, kc)
                read[stage] = True
                seen.append((t, by, kc))
                stage = (stage + 1) % stages
                kc += 1
                if kc == nk:
                    t, kc = t + p.grid[0], 0
    return seen, tiles, nk


@pytest.mark.parametrize("rows", [1, 127, 129, 1000, 2 ** 20])
@pytest.mark.parametrize("n,m", [(128, 256), (128, 64), (36, 300),
                                 (64, 4), (64, 1)])
def test_onn_layer_persistent_walk_covers_each_tile_once(n, m, rows):
    p = onn_layer.plan(rows, n, m, 0, 0)
    assert p.form == ("wide" if m > 8 else "fan_in")
    stages = (onn_layer.WIDE_STAGES if p.form == "wide"
              else onn_layer.FAN_IN_STAGES)
    seen, tiles, nk = _ring_walk(p, rows, n, stages)
    col_tiles = -(-m // p.tile) if p.form == "wide" else 1
    assert p.grid[1] == col_tiles and p.grid[0] <= tiles
    assert sorted(seen) == [(t, c, k) for t in range(tiles)
                            for c in range(col_tiles) for k in range(nk)]


@pytest.mark.parametrize("rows", [1, 127, 129, 1000, 2 ** 20])
@pytest.mark.parametrize("m", [1, 4, 12, 64, 1024])
def test_onn_layer_fan_out_walk_covers_each_row_once(m, rows):
    """The fan-out form's grid-stride loop: thread i of block bx starts
    at row bx * per_pass + i // (m / cpt) and takes four rows a pass, a
    grid's rows apart."""
    p = onn_layer.plan(rows, 4, m, 0, 0)
    groups = m // p.tile
    per_pass = p.threads // groups
    assert p.form == "fan_out" and p.threads <= onn_layer.THREADS
    step = p.grid[0] * per_pass
    counts = np.zeros(rows, np.int64)
    for bx in range(p.grid[0]):
        for rr in range(per_pass):
            for r0 in range(bx * per_pass + rr, rows, 4 * step):
                for r in range(r0, min(r0 + 4 * step, rows), step):
                    counts[r] += 1
    assert (counts == 1).all() and p.grid[0] <= -(-rows // per_pass)


# ------------------------------------------------------------- encoding
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_symbol_encoding_matches_jax_bit_for_bit(bits, k):
    rng = np.random.default_rng(bits * 10 + k)
    n = 3
    codes = rng.integers(0, 2 ** bits - 1, size=(n, 7, 11)).astype(np.int32)
    sym = encoding.pam4_encode(_t(codes), bits)
    jsym = jenc.pam4_encode(jnp.asarray(codes), bits)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    assert sym.dtype == torch.int32
    np.testing.assert_array_equal(encoding.pam4_decode(sym).numpy(), codes)
    np.testing.assert_array_equal(
        encoding.expected_avg_symbols(sym, bits).numpy(),
        np.asarray(jenc.expected_avg_symbols(jsym, bits)))
    assert encoding.preprocess_group_size(bits, k) == \
        jenc.preprocess_group_size(bits, k)
    np.testing.assert_array_equal(
        encoding.group_symbols(sym, bits, k).numpy(),
        np.asarray(jenc.group_symbols(jsym, bits, k)))
    a = encoding.preprocess(sym, bits, k)
    ja = jenc.preprocess(jsym, bits, k)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(
        encoding.group_value(a, bits, k).numpy(),
        np.asarray(jenc.group_value(ja, bits, k)))
    np.testing.assert_array_equal(
        encoding.oracle_from_preprocessed(a, bits, k).numpy(),
        np.asarray(jenc.oracle_from_preprocessed(ja, bits, k)))
    analog = rng.normal(1.5, 1.0, size=(5, encoding.num_symbols(bits)))
    analog = analog.astype(np.float32)
    np.testing.assert_array_equal(
        encoding.symbol_value(_t(analog)).numpy(),
        np.asarray(jenc.symbol_value(jnp.asarray(analog))))
    np.testing.assert_array_equal(
        encoding.splitter(sym[0], n).numpy(),
        np.asarray(jenc.splitter(jsym[0], n)))


# ------------------------------------------------------------------ onn
def test_config_and_area_match_jax():
    assert (config.FIDELITIES, config.PARAM_SOURCES, config.MESH_BACKENDS) \
        == (jconfig.FIDELITIES, jconfig.PARAM_SOURCES, jconfig.MESH_BACKENDS)
    assert dataclasses.asdict(config.PhotonicsConfig()) == \
        dataclasses.asdict(jconfig.PhotonicsConfig())
    for bad in (dict(fidelity="x"), dict(params="x"),
                dict(mesh_backend="x"), dict(blk_b=4), dict(blk_b=-8),
                dict(theta_drift_std=-1.0), dict(shot_noise_std=-1.0)):
        with pytest.raises(ValueError) as want:
            jconfig.PhotonicsConfig(**bad)
        with pytest.raises(ValueError) as got:
            config.PhotonicsConfig(**bad)
        assert str(got.value) == str(want.value)
    from repro.photonics import area as jarea
    for structure, approx in (((4, 64, 128, 256, 128, 64, 4), {2, 3, 4}),
                              ((1, 4, 1), set())):
        assert area.layer_dims(list(structure)) == \
            jarea.layer_dims(list(structure))
        assert area.area_mzis(list(structure), approx) == \
            jarea.area_mzis(list(structure), approx)
        assert area.area_ratio(list(structure), approx) == \
            jarea.area_ratio(list(structure), approx)


def test_runtime_structures_and_configs_match_jax():
    for bits in range(2, 17):
        for k in range(1, 5):
            assert runtime.clamp_k(bits, k) == jruntime.clamp_k(bits, k)
            assert runtime.default_structure(bits, k) == \
                jruntime.default_structure(bits, k)
            for n in (1, 3, 4):
                ph = config.PhotonicsConfig(fidelity="onn", k_inputs=k)
                jph = jconfig.PhotonicsConfig(fidelity="onn", k_inputs=k)
                cfg = runtime.onn_config(ph, bits, n)
                jcfg = jruntime.onn_config(jph, bits, n)
                assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
                assert (cfg.in_scale, cfg.out_scale) == \
                    (jcfg.in_scale, jcfg.out_scale)
                assert onn.area_ratio(cfg) == jonn.area_ratio(jcfg)


def _grid_inputs(bits, n, rows, seed):
    """Unit-P inputs of ``rows`` random n-peer code tuples, (rows, K)."""
    rng = np.random.default_rng(seed)
    k = runtime.clamp_k(bits, 4)
    codes = rng.integers(0, 2 ** bits - 1, size=(n, rows)).astype(np.int32)
    return np.asarray(jenc.preprocess(jenc.pam4_encode(
        jnp.asarray(codes), bits), bits, k))


def test_onn_apply_matches_jitted_jax_on_carried_weights():
    """The default bits-8 structure on JAX-seeded weights carried across
    with params_from_jax; inputs on the unit-P grid of 4 peers."""
    ph = jconfig.PhotonicsConfig(fidelity="onn")
    jcfg = jruntime.onn_config(ph, 8, 4)
    jparams = jonn.init_params(jcfg, jax.random.PRNGKey(0))
    a = _grid_inputs(8, 4, 3000, 1)
    want = np.asarray(jax.jit(lambda x: jonn.apply(jparams, x, jcfg))(
        jnp.asarray(a)))
    cfg = runtime.onn_config(config.PhotonicsConfig(fidelity="onn"), 8, 4)
    params = onn.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert [tuple(l["w"].shape) for l in params] == area.layer_dims(
        list(cfg.structure))
    got = onn.apply(params, _t(a), cfg)
    assert got.shape == want.shape == (3000, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ONN_RTOL * np.abs(want).max())
    far = np.abs(np.abs(want - np.floor(want)) - 0.5) > THRESHOLD_MARGIN
    sym = onn.readout(got).numpy()
    jsym = np.asarray(jonn.readout(jnp.asarray(want)))
    np.testing.assert_array_equal(sym[far], jsym[far])
    assert far.mean() > 0.99 and len(np.unique(jsym)) == 4
    # a leading batch dim goes through too
    assert torch.equal(onn.apply(params, _t(a).reshape(3, 1000, 4), cfg),
                       got.reshape(3, 1000, 4))
    mod = ONNModule.from_params(cfg, params)
    assert torch.equal(mod.symbols(_t(a)), onn.readout(got))


def test_init_params_are_seeded_he_normal():
    cfg = onn.ONNConfig(structure=(4, 64, 128, 256, 128, 64, 4))
    p1 = onn.init_params(cfg, 3, "cpu")
    p2 = onn.init_params(cfg, 3, "cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(p1, p2))
    for layer, (m, n) in zip(p1, area.layer_dims(list(cfg.structure))):
        assert layer["w"].shape == (m, n) and layer["w"].dtype == torch.float32
        assert torch.equal(layer["b"], torch.zeros(m))
        assert abs(layer["w"].std().item() - (2.0 / n) ** 0.5) < 0.3 * (
            2.0 / n) ** 0.5
    mod = ONNModule.init(cfg, 3)
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(mod.params, p1))


def test_exact_identity_module_is_the_oracle():
    """All 27 three-server code combinations at bits 2: the built-in
    exact ONN reproduces Q(mean), as the JAX module does."""
    module = ONNModule.exact_identity(bits=2, n_servers=3)
    jmodule = JaxONNModule.exact_identity(bits=2, n_servers=3)
    assert module.cfg == runtime.onn_config(
        config.PhotonicsConfig(), 2, 3)
    for l, jl in zip(module.params, jmodule.params):
        np.testing.assert_array_equal(l["w"].numpy(), jl["w"])
        np.testing.assert_array_equal(l["b"].numpy(), jl["b"])
    codes = np.stack(np.meshgrid(*([np.arange(3)] * 3),
                                 indexing="ij")).reshape(3, -1)
    sym = encoding.pam4_encode(_t(codes.astype(np.int32)), 2)
    a = encoding.preprocess(sym, 2, module.cfg.k_inputs)
    want = encoding.expected_avg_symbols(sym, 2)
    np.testing.assert_array_equal(module.symbols(a).numpy(), want.numpy())
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jmodule.symbols(
            jnp.asarray(a.numpy()), fidelity="onn")))
    with pytest.raises(ValueError, match="single PAM4 symbol"):
        ONNModule.exact_identity(bits=8, n_servers=4)
    # the mesh fidelity (ported since): the same codes through the
    # meshes, which for the wire-exact weights hold no rotation
    np.testing.assert_array_equal(
        module.symbols(a, fidelity="mesh").numpy(), want.numpy())
    assert all(p.u.n_rot == p.v.n_rot == 0 for p in module.programs)
    # ONN training (ported since): the same cfg trains on the CPU
    trained = ONNModule.train(module.cfg, epochs=1, device="cpu")
    assert trained.cfg == module.cfg
    assert [l["w"].shape for l in trained.params] == [(4, 1), (1, 4)]


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("bits,n", [(2, 3), (8, 3), (8, 4)])
def test_pipeline_level_matches_jitted_jax(bits, n):
    """One pipeline level over n stacked peers against the JAX level on
    the codes' psum, jitted (a vmap over a named axis stands in for the
    peers' mesh axis); both emit the eq.-10 carry."""
    rng = np.random.default_rng(bits + n)
    codes = rng.integers(0, 2 ** bits - 1, size=(n, 2000)).astype(np.int32)
    ph = jconfig.PhotonicsConfig(fidelity="onn")
    if bits == 2:
        jmod = jruntime.get_module(ph, bits, n)
        mod = runtime.get_module(config.PhotonicsConfig(fidelity="onn"),
                                 bits, n)
    else:
        jcfg = jruntime.onn_config(ph, bits, n)
        jmod = JaxONNModule.init(jcfg, jax.random.PRNGKey(n))
        mod = ONNModule.from_params(runtime.onn_config(
            config.PhotonicsConfig(fidelity="onn"), bits, n), jmod.params)
    jpipe_ = jpipe.level_pipeline(jmod, bits, ("p",), emit_carry=True)
    run = jax.jit(jax.vmap(lambda c: tuple(jpipe_.run(c)), axis_name="p"))
    jdata, jfrac = (np.asarray(x)[0] for x in run(jnp.asarray(codes)))
    out = pipeline.level_pipeline(mod, bits, emit_carry=True).run(_t(codes))
    assert out.data.dtype == torch.int32 and out.data.shape == (2000,)
    analog = mod.apply(pipeline.Preprocess().apply(pipeline.Encode(
        bits, mod.cfg.k_inputs).apply(pipeline.Carry(_t(codes)))).data)
    far = (np.abs(np.abs(analog.numpy() - np.floor(analog.numpy())) - 0.5)
           > THRESHOLD_MARGIN).all(-1)
    np.testing.assert_array_equal(out.data.numpy()[far], jdata[far])
    np.testing.assert_allclose(out.frac.numpy()[far], jfrac[far], rtol=0,
                               atol=1e-3)
    if bits == 2:
        assert far.all()
        want = encoding.qmean(_t(codes))
        np.testing.assert_array_equal(out.data.numpy(), want.numpy())


# --------------------------------------------------------------- runtime
def test_runtime_refuses_untrained_wide_bits(monkeypatch, clean_cache):
    monkeypatch.setattr(runtime, "RESULTS_PICKLES",
                        ("results/_absent_for_test.pkl",))
    with pytest.raises(ValueError, match="no trained params"):
        runtime._build(config.PhotonicsConfig(fidelity="onn"), 8, 4)
    with pytest.raises(ValueError, match="no matching pickle"):
        runtime._build(config.PhotonicsConfig(fidelity="onn",
                                              params="results"), 8, 4)
    # params='train' (ported since) needs a budget, as in JAX
    with pytest.raises(ValueError, match="train_epochs>0"):
        runtime._build(config.PhotonicsConfig(fidelity="onn",
                                              params="train"), 8, 4)
    m = runtime.get_module(config.PhotonicsConfig(fidelity="onn"), 2, 3)
    assert m.cfg.structure == (1, 4, 1)
    assert runtime.get_module(config.PhotonicsConfig(fidelity="onn"), 2,
                              3) is m


def test_put_get_module_and_a_cache_key_without_executor_knobs(clean_cache):
    ph = config.PhotonicsConfig(fidelity="onn")
    knobs = config.PhotonicsConfig(fidelity="onn", mesh_backend="pallas",
                                   blk_b=64, theta_drift_std=0.1,
                                   shot_noise_std=0.2)
    assert runtime._cache_key(knobs, 8, 4) == runtime._cache_key(ph, 8, 4)
    assert runtime._cache_key(ph, 8, 4) != runtime._cache_key(ph, 8, 2)
    assert runtime._cache_key(ph, 8, 4) != runtime._cache_key(
        dataclasses.replace(ph, k_inputs=2), 8, 4)
    cfg = runtime.onn_config(ph, 8, 4)
    module = ONNModule.init(cfg, 0)
    runtime.put_module(ph, 8, 4, module)
    assert runtime.get_module(knobs, 8, 4) is module
    assert runtime.warmup(SimpleSync(ph, 8), 4, "cpu") is module
    assert runtime.warmup(SimpleSync(config.PhotonicsConfig(), 8), 4) is None


@dataclasses.dataclass(frozen=True)
class SimpleSync:
    photonics: object
    bits: int


def _write_jax_pickle(root: Path, seed=0):
    """What quickstart --onn --scenario1 persists, written by the JAX
    package."""
    jcfg = jruntime.onn_config(jconfig.PhotonicsConfig(fidelity="onn"), 8, 4)
    jparams = jonn.init_params(jcfg, jax.random.PRNGKey(seed))
    (root / "results").mkdir()
    with open(root / "results" / "scenario1_params.pkl", "wb") as f:
        pickle.dump({"cfg": jcfg, "params": [
            {"w": np.asarray(l["w"]), "b": np.asarray(l["b"])}
            for l in jparams]}, f)
    return jcfg, jparams


def test_a_jax_results_pickle_loads_without_jax(tmp_path, monkeypatch,
                                                clean_cache):
    jcfg, jparams = _write_jax_pickle(tmp_path)
    monkeypatch.setattr(runtime, "_REPO_ROOT", tmp_path)
    module = runtime._build(config.PhotonicsConfig(fidelity="onn"), 8, 4)
    assert isinstance(module.cfg, onn.ONNConfig)
    assert dataclasses.asdict(module.cfg) == dataclasses.asdict(jcfg)
    for l, jl in zip(module.params, jparams):
        np.testing.assert_array_equal(l["w"].numpy(), np.asarray(jl["w"]))
        np.testing.assert_array_equal(l["b"].numpy(), np.asarray(jl["b"]))
    # an explicit structure that differs from the saved one: no match
    with pytest.raises(ValueError, match="no trained params"):
        runtime._build(config.PhotonicsConfig(
            fidelity="onn", structure=(4, 8, 4)), 8, 4)
    # and a pickle naming another class of the JAX package is refused
    with open(tmp_path / "results" / "scenario1_params.pkl", "wb") as f:
        pickle.dump({"cfg": jconfig.PhotonicsConfig(), "params": []}, f)
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        runtime._build(config.PhotonicsConfig(fidelity="onn"), 8, 4)

    other = tmp_path / "other"
    other.mkdir()
    _write_jax_pickle(other)
    code = ("import sys, pathlib\n"
            "from repro_torch.photonics import config, runtime\n"
            f"runtime._REPO_ROOT = pathlib.Path({str(other)!r})\n"
            "m = runtime._build(config.PhotonicsConfig(fidelity='onn'), 8, "
            "4)\n"
            "assert m.cfg.structure == (4, 64, 128, 256, 128, 64, 4)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
