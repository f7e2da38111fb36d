"""The port's hardware-aware ONN training on the CPU
(``repro_torch.photonics.{dataset,training}``, ``ONNModule.train``,
``params='train'``), held against the JAX package on the same inputs.

The datasets are numpy in both packages and held bit for bit.  JAX's
initial parameters are carried across (``onn.params_from_jax``), so both
sides start from the same weights.  The forward pass sums f32 products
in another order than XLA, so the losses and gradients are held to a
stated tolerance; one Adam update, given the same gradients, is held bit
for bit (the port writes the FMAs XLA forms).  The JAX side runs jitted,
as its training step does.  Nothing here builds or launches CUDA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.photonics import dataset as jdataset
from repro.photonics import training as jtraining
from repro.photonics.onn import ONNConfig as JaxONNConfig
from repro_torch.photonics import (approx, config, dataset, mesh, onn,
                                   runtime, training)
from repro_torch.photonics.module import ONNModule
from repro_torch.photonics.onn import ONNConfig

TINY_KW = dict(structure=(2, 64, 128, 64, 2), approx_layers=(2, 3), bits=4,
               n_servers=2, k_inputs=2)          # tests/test_onn.py:8
SCENARIO1_KW = dict(structure=(4, 64, 128, 256, 128, 64, 4),
                    approx_layers=(1, 2, 3, 4, 5, 6), bits=8, n_servers=4,
                    k_inputs=4)
TINY, JTINY = ONNConfig(**TINY_KW), JaxONNConfig(**TINY_KW)
# a full-batch loss over the grid, port vs jitted JAX from the same
# weights: f32 sums of up to 128 products in another order (~1e-7
# relative, measured); the gradients against each leaf's largest entry
LOSS_RTOL = 1e-6
GRAD_RTOL = 5e-6
# 20 epochs of Adam (lr 1e-2) from the same weights: the reordered sums
# of every step move the weights by a few ulp, and Adam's normalized
# step carries that on (measured: the loss histories within 3e-7 of the
# first loss, the final weights within 1e-5 of their largest entry)
HISTORY_RTOL = 1e-5
WEIGHT_RTOL = 1e-4
# the constrained weight, port vs jitted JAX: a batched LU solve of
# blocks up to 64 x 64 in another library, then one product
CAYLEY_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def grid():
    return jdataset.full_dataset(JTINY)


def _jax_init(cfg, mode, seed=0):
    return jtraining.init_params(cfg, jax.random.PRNGKey(seed), mode)


def _dyn(params):
    return [{k: v for k, v in layer.items() if k != "shape"}
            for layer in params]


def _with_shapes(dyn, params):
    return [dict(d, shape=p["shape"]) if "shape" in p else d
            for d, p in zip(dyn, params)]


def _leaves(tree):
    return [np.asarray(v) for layer in tree for _, v in sorted(layer.items())
            if not isinstance(v, tuple)]


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("kw", [TINY_KW, SCENARIO1_KW],
                         ids=["tiny", "scenario1"])
def test_datasets_are_jax_bit_for_bit(kw):
    cfg, jcfg = ONNConfig(**kw), JaxONNConfig(**kw)
    np.testing.assert_array_equal(dataset.grid_values(cfg),
                                  jdataset.grid_values(jcfg))
    a, t = dataset.full_dataset(cfg)
    ja, jt = jdataset.full_dataset(jcfg)
    assert a.dtype == ja.dtype and t.dtype == jt.dtype
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(t, jt)
    assert len(a) == dataset.dataset_size(cfg)
    got = dataset.sampled_dataset(cfg, np.random.default_rng(3), 500)
    want = jdataset.sampled_dataset(jcfg, np.random.default_rng(3), 500)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = dataset.server_side_dataset(cfg, np.random.default_rng(4), 300)
    want = jdataset.server_side_dataset(jcfg, np.random.default_rng(4), 300)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_dataset_sizes_match_the_paper_formula():
    for bits, size in ((8, 13 ** 4), (16, 61 ** 4)):
        cfg = ONNConfig(structure=(4,), bits=bits, n_servers=4, k_inputs=4)
        assert dataset.dataset_size(cfg) == size
        assert size == jdataset.dataset_size(JaxONNConfig(
            structure=(4,), bits=bits, n_servers=4, k_inputs=4))


# ---------------------------------------------------- model and losses
@pytest.mark.parametrize("mode", ["uniform", "pow2", "pow4"])
def test_symbol_weights_match_jax(mode):
    for m in (1, 2, 4):
        np.testing.assert_array_equal(
            training.symbol_weights(m, mode).numpy(),
            np.asarray(jtraining.symbol_weights(m, mode)))
    with pytest.raises(ValueError):
        training.symbol_weights(2, "pow3")


@pytest.mark.parametrize("m,n", [(64, 64), (128, 64), (64, 128), (4, 64),
                                 (64, 4)])
def test_materialize_constrained_matches_jitted_jax(m, n):
    layer = jtraining.init_constrained_layer(jax.random.PRNGKey(m + n), m, n)
    want = np.asarray(jax.jit(lambda p, d: jtraining.materialize_constrained(
        {"p": p, "d": d, "shape": (m, n)}))(layer["p"], layer["d"]))
    got = training.materialize_constrained(
        onn.params_from_jax([layer], "cpu")[0])
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CAYLEY_ATOL)
    # the blocks are d-scaled rotations: rows of U have unit norm
    s = min(m, n)
    blocks = (got.reshape(m // s, s, n) if m >= n else
              got.reshape(m, n // s, s).permute(1, 0, 2))
    d = np.asarray(layer["d"])
    for b, ub in enumerate(blocks):
        u = ub.numpy() / d[b][:, None]
        np.testing.assert_allclose(u @ u.T, np.eye(s), atol=1e-4)


@pytest.mark.parametrize("mode", ["project", "cayley"])
def test_apply_onn_matches_jitted_jax(mode, grid):
    a, _ = grid
    jp = _jax_init(JTINY, mode)
    want = np.asarray(jax.jit(lambda p: jtraining.apply_onn(
        _with_shapes(p, jp), jnp.asarray(a), JTINY))(_dyn(jp)))
    got = training.apply_onn(onn.params_from_jax(jp, "cpu"),
                             torch.from_numpy(a), TINY)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    dense = training.to_dense(onn.params_from_jax(jp, "cpu"))
    assert all(set(layer) == {"w", "b"} for layer in dense)
    np.testing.assert_allclose(training.apply_onn(
        dense, torch.from_numpy(a), TINY).numpy(), got.numpy(), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("mode", ["project", "cayley"])
def test_stage_losses_and_gradients_match_jitted_jax(mode, stage, grid):
    a, t = grid
    jp = _jax_init(JTINY, mode, seed=stage)
    jf = jtraining.stage1_loss if stage == 1 else jtraining.stage2_loss
    w = jtraining.symbol_weights(2, "uniform")
    jl, jg = jax.jit(jax.value_and_grad(lambda d: jf(
        _with_shapes(d, jp), jnp.asarray(a), jnp.asarray(t), JTINY, w)))(
        _dyn(jp))
    tp = onn.params_from_jax(jp, "cpu")
    leaves = [v.requires_grad_() for layer in tp
              for _, v in sorted(layer.items()) if isinstance(v, torch.Tensor)]
    f = training.stage1_loss if stage == 1 else training.stage2_loss
    loss = f(tp, torch.from_numpy(a), torch.from_numpy(t), TINY,
             training.symbol_weights(2, "uniform"))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for g, want in zip(grads, _leaves(jg)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())


def test_ste_round_is_round_clip_forward_identity_backward():
    x = torch.tensor([-0.7, 0.2, 1.5, 2.5, 2.6, 3.4, 7.0],
                     requires_grad=True)
    y = training._ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  [0.0, 0.0, 2.0, 2.0, 3.0, 3.0, 3.0])
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(7))


@pytest.mark.parametrize("mode", ["project", "cayley"])
def test_two_adam_updates_are_jax_bit_for_bit(mode):
    """Given the same gradients, the port's Adam is the jitted JAX update
    bit for bit: XLA's fma(b1, m, (1 - b1) g) and fma(b2, v, ((1 - b2) g)
    g), f32 bias corrections and a correctly rounded square root."""
    dyn = _dyn(_jax_init(JTINY, mode))
    rng = np.random.default_rng(7)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), dyn)
    update = jax.jit(jtraining._adam_update)
    p1, s1 = update(dyn, g, jtraining._adam_init(dyn), 0.01)
    p2, s2 = update(p1, g, s1, 0.009)

    def tree(x):
        return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                for layer in x]

    q1, r1 = training._adam_update(tree(dyn), tree(g),
                                   training._adam_init(tree(dyn)), 0.01)
    q2, r2 = training._adam_update(q1, tree(g), r1, 0.009)
    assert r2["t"] == 2 and int(s2["t"]) == 2
    for want, got in ((p2, q2), (s2["m"], r2["m"]), (s2["v"], r2["v"])):
        for w, x in zip(_leaves(want), _leaves(got)):
            np.testing.assert_array_equal(x, w)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("mode,batch", [("project", 0), ("cayley", 0),
                                        ("project", 16)],
                         ids=["project", "cayley", "project-minibatch"])
def test_train_follows_jax_for_20_epochs(mode, batch, grid):
    """Both loops from JAX's initial weights: the stage switch at e1, the
    cosine lr, projections every 10 epochs, the mini-batch permutation
    and the final projection; the loss histories agree within
    HISTORY_RTOL, the records field for field otherwise."""
    a, t = grid
    tcfg = dict(epochs=20, e1=12, lr=1e-2, proj_every=10, mode=mode,
                batch_size=batch, seed=5)
    jparams, jhist = jtraining.train(JTINY, jtraining.TrainConfig(**tcfg),
                                     a, t, eval_every=10)
    params, hist = training.train(
        TINY, training.TrainConfig(**tcfg), a, t, eval_every=10,
        init=onn.params_from_jax(_jax_init(JTINY, mode, 5), "cpu"),
        device="cpu")
    assert len(hist) == len(jhist) == 20
    scale = abs(jhist[0]["loss"])
    for rec, jrec in zip(hist, jhist):
        assert {k: v for k, v in rec.items() if k not in ("loss", "acc")} \
            == {k: v for k, v in jrec.items() if k not in ("loss", "acc")}
        assert abs(rec["loss"] - jrec["loss"]) <= HISTORY_RTOL * scale
        assert ("acc" in rec) == ("acc" in jrec)
    assert [r["stage"] for r in hist] == [1] * 12 + [2] * 8
    assert [r["projected"] for r in hist].count(True) == \
        (2 if mode == "project" else 0)
    for layer, jlayer in zip(params, jparams):
        assert set(layer) == {"w", "b"}
        np.testing.assert_allclose(layer["w"].numpy(), np.asarray(
            jlayer["w"]), rtol=0,
            atol=WEIGHT_RTOL * np.abs(jlayer["w"]).max())
    for idx in TINY.approx_layers:
        assert approx.approx_error(params[idx - 1]["w"]) < 1e-4


def test_train_stops_at_target_accuracy_and_switches_stages(grid):
    a, t = grid
    _, hist = training.train(TINY, training.TrainConfig(
        epochs=4, e1=2, lr=1e-3), a, t, device="cpu")
    assert [h["stage"] for h in hist] == [1, 1, 2, 2]
    _, hist = training.train(TINY, training.TrainConfig(
        epochs=40, e1=30, mode="cayley"), a, t, eval_every=2,
        target_acc=0.0, device="cpu")
    assert len(hist) == 2 and hist[-1]["acc"] >= 0.0


def test_accuracy_and_error_histogram_equal_jax(grid):
    a, t = grid
    jp = jtraining.to_dense(_jax_init(JTINY, "cayley"))
    tp = onn.params_from_jax(jp, "cpu")
    got = training.accuracy(tp, a, t, TINY, device="cpu")
    assert got == jtraining.accuracy(jp, a, t, JTINY) < 1.0
    hist = training.error_histogram(tp, a, t, TINY, batch=10, device="cpu")
    assert hist == jtraining.error_histogram(jp, a, t, JTINY)
    assert hist and all(isinstance(k, int) for k in hist)
    assert sum(hist.values()) == round((1 - got) * len(a))
    module = ONNModule.from_params(TINY, tp)
    assert module.accuracy(a, t, device="cpu") == got


def test_init_params_are_seeded_in_both_parametrizations():
    for mode in ("project", "cayley"):
        p0 = training.init_params(TINY, 3, mode)
        p1 = training.init_params(TINY, 3, mode)
        assert [sorted(l) for l in p0] == [sorted(l) for l in p1]
        for l0, l1 in zip(p0, p1):
            for k in l0:
                if k != "shape":
                    assert torch.equal(l0[k], l1[k])
    cay = training.init_params(TINY, 3, "cayley")
    assert [sorted(l) for l in cay] == [
        ["b", "w"], ["b", "d", "p", "shape"], ["b", "d", "p", "shape"],
        ["b", "w"]]
    assert cay[1]["p"].shape == (2, 64, 64) and cay[1]["shape"] == (128, 64)
    assert cay[2]["d"].shape == (2, 64) and cay[2]["shape"] == (64, 128)
    jp = _jax_init(JTINY, "cayley")
    assert [sorted(l) for l in onn.params_from_jax(jp, "cpu")] == [
        sorted(l) for l in jp]


def test_training_entry_points_need_cuda_unless_told(monkeypatch, grid):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, t = grid
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train(TINY, training.TrainConfig(epochs=1), a, t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.accuracy(training.init_params(TINY), a, t, TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ONNModule.train(TINY, epochs=1)


@pytest.mark.parametrize("mode", ["project", "cayley"])
def test_tiny_training_reaches_full_accuracy(mode, grid):
    """The port's copy of tests/test_onn.py's accuracy run, at the JAX
    recipe (3000 epochs at most, early stop at accuracy 1)."""
    a, t = grid
    tc = training.TrainConfig(epochs=3000, e1=2500, lr=1e-2, mode=mode,
                              proj_every=200)
    params, _ = training.train(TINY, tc, a, t, eval_every=200,
                               target_acc=1.0, device="cpu")
    acc = training.accuracy(params, a, t, TINY, device="cpu")
    assert acc >= (0.98 if mode == "cayley" else 0.93), acc
    for idx, layer in enumerate(params, start=1):
        if idx in TINY.approx_layers:
            assert approx.approx_error(layer["w"]) < 1e-4


def test_trained_mesh_matches_the_software_function(grid):
    """Givens-programmed MZI meshes of a trained ONN reproduce its
    function: the numpy oracle and the port's executor (both
    backends)."""
    a, t = grid
    params, _ = training.train(TINY, training.TrainConfig(
        epochs=300, e1=300, lr=1e-2), a, t, device="cpu")
    sw = training.apply_onn(params, torch.from_numpy(a[:64]), TINY).numpy()
    hw = onn.map_to_hardware(params, TINY)
    np.testing.assert_allclose(onn.apply_hardware(hw, a[:64], TINY), sw,
                               atol=1e-3)
    progs = mesh.compile_hardware(hw)
    for backend in ("xla", "pallas"):
        np.testing.assert_allclose(mesh.apply_hardware(
            progs, torch.from_numpy(a[:64]), TINY, backend).numpy(), sw,
            atol=1e-3)


def test_module_train_and_params_train_resolve(monkeypatch, grid):
    """ONNModule.train (cayley, e1 = 0.8 epochs) and the runtime's
    params='train' source, on the CPU; the JAX module trains the same
    way (its cfg, the same dataset)."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    module = ONNModule.train(TINY, epochs=30, seed=2, device="cpu")
    assert [sorted(l) for l in module.params] == [["b", "w"]] * 4
    assert all(l["w"].device.type == "cpu" for l in module.params)
    for idx in TINY.approx_layers:
        assert approx.approx_error(module.params[idx - 1]["w"]) < 1e-4
    sampled = ONNModule.train(TINY, epochs=2, seed=2, samples=20,
                              device="cpu")
    assert sampled.cfg == TINY
    ph = config.PhotonicsConfig(fidelity="onn", params="train",
                                train_epochs=4, structure=TINY.structure,
                                approx_layers=TINY.approx_layers,
                                k_inputs=TINY.k_inputs)
    got = runtime.get_module(ph, TINY.bits, TINY.n_servers, "cpu")
    assert got.cfg == runtime.onn_config(ph, TINY.bits, TINY.n_servers)
    assert got.cfg == TINY
    assert runtime.get_module(ph, TINY.bits, TINY.n_servers) is got
    with pytest.raises(ValueError, match="train_epochs>0"):
        runtime._build(dataclasses.replace(ph, train_epochs=0), 8, 4, "cpu")
