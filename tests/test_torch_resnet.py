"""The port's ResNet-50 (``repro_torch.models.resnet``) and its data
(``repro_torch.data.pipeline.synthetic_images``) on the CPU, held
against the JAX package's ``repro.models.resnet`` and
``repro.data.pipeline`` on the same inputs, and ``benchmarks/fig7a.py``'s
ResNet step (value_and_grad of ``loss_fn``, ``sync_gradients`` at bits
8, block 2048, then SGD at lr 0.05) on a 1-device mesh, as fig7a runs
it, against the same step on the port.

Bit for bit: the images, ``params_from_jax``, the full-width leaf
shapes and bucket bounds (from ``jax.eval_shape``, no compute), and 2
gloo ranks of the step against 2 stacked peers.  XLA and PyTorch sum
convolutions and reductions in other orders, so the model's outputs and
gradients are held to stated f32 tolerances.  The narrow cases set
``BLOCKS`` and ``WIDTHS`` in both packages (the two modules read them
at call time); nothing in the JAX package changes.
"""
import contextlib
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat  # noqa: F401  (jax API shims)
from repro.collectives import SyncConfig as JaxSyncConfig
from repro.collectives import sync_gradients as jax_sync_gradients
from repro.collectives.bucketizer import make_layout as jax_make_layout
from repro.data import pipeline as jdata
from repro.launch.mesh import make_mesh
from repro.models import resnet as jr
from repro_torch.collectives.bucketizer import make_layout
from repro_torch.data import pipeline as tdata
from repro_torch.models import resnet as tr
from repro_torch.tree import leaves, leaves_with_paths, unflatten
from test_torch_processes import _env, _free_port, _wait
from test_torch_train import TRAIN_TOL

ROOT = Path(__file__).resolve().parents[1]
NARROW = ((1, 1, 1, 1), (8, 16, 32, 64))
# conv at stride 1 and 2: the same f32 products summed in another order
# (read 0 in every case here)
CONV_RTOL = 1e-5
# the narrow model's logits against their largest and its loss,
# relative (a few ulp an op through ~20 ops; read 1.2e-6 and 6.5e-7, 0
# and 1.0e-7 at 8 x 8 and 32 x 32), and each gradient leaf against its
# largest entry (read 2.0e-6 and 2.5e-6)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the port's init against JAX's, each normal leaf's mean and standard
# deviation: two samples of n draws of N(0, s^2) differ in mean by
# s sqrt(2 / n) and in standard deviation by s / sqrt(n) (one sigma)
INIT_SIGMAS = 6
RANKS = 2
RANK_STEPS = 2
SPAWN_TIMEOUT_S = 300

# fig7a's step on the port, as the ranks run it too (they exec this)
STEP_LIB = textwrap.dedent('''
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.collectives.engine import SyncConfig, sync_gradients
    from repro_torch.data.pipeline import synthetic_images
    from repro_torch.models import resnet
    from repro_torch.tree import leaves, tree_map, unflatten

    LR = 0.05


    def fig7a_step(params, images, labels, sync, key, peers, world=None):
        """Peer p's loss and gradients on rows [p B/N, (p+1) B/N) (this
        rank's peer alone with ``world``), one sync_gradients call, SGD;
        the loss is the peers' losses summed and divided by N.  Returns
        (params, loss, pre-sync gradients (peers stacked), synced)."""
        per = images.shape[0] // peers
        own = range(peers) if world is None else [world.rank]
        train = [t.detach().requires_grad_() for t in leaves(params)]
        tparams = unflatten(params, train)
        losses, grads = [], []
        for p in own:
            loss, _ = resnet.loss_fn(tparams, images[p * per:(p + 1) * per],
                                     labels[p * per:(p + 1) * per])
            grads.append(torch.autograd.grad(loss, train))
            losses.append(loss.detach())
        stacked = unflatten(params, [torch.stack(g) for g in zip(*grads)])
        synced, _ = sync_gradients(stacked, sync, None, key, world=world)
        params = tree_map(lambda p, g: p - LR * g, params, synced)
        losses = torch.stack(losses)
        if world is not None:
            losses = world.gather_rows(losses)
        return params, losses.sum() / peers, stacked, synced


    def run_steps(params, mode, peers, steps, batch, shape, world=None):
        """``steps`` steps of fig7a's step on synthetic_images; returns
        (params, whole losses, each step's pre-sync gradients)."""
        sync = SyncConfig(mode=mode, axes=("data",), bits=8, block=2048)
        losses, grads = [], []
        for s in range(steps):
            images, labels = synthetic_images(s, batch, shape=shape)
            params, loss, g, _ = fig7a_step(
                params, torch.from_numpy(images), torch.from_numpy(labels),
                sync, prng.fold_in(prng.PRNGKey(1), s), peers, world)
            losses.append(loss.item())
            grads.append(g)
        return params, losses, grads
''')

RANK_MAIN = textwrap.dedent('''
    import json, sys
    torch.set_num_threads(1)
    from repro_torch.launch import distributed

    spec = json.loads(sys.argv[1])
    resnet.BLOCKS, resnet.WIDTHS = (tuple(x) for x in spec["narrow"])
    world = distributed.init(1, spec["ranks"], 1, "cpu")
    params, losses, _ = run_steps(
        resnet.init_params(0, device="cpu"), "optinc", spec["ranks"],
        spec["steps"], spec["batch"], (32, 32, 3), world)
    np.savez(f"{spec['out']}/rank{world.rank}.npz",
             losses=np.array(losses, np.float64),
             **{str(i): p.numpy() for i, p in enumerate(leaves(params))})
    distributed.shutdown()
    distributed.exit_rank(0)
''')

LIB = {}
exec(STEP_LIB, LIB)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def width(blocks, widths):
    """Both packages' ResNet with BLOCKS and WIDTHS set to these."""
    old = [(m, m.BLOCKS, m.WIDTHS) for m in (jr, tr)]
    for m in (jr, tr):
        m.BLOCKS, m.WIDTHS = blocks, widths
    try:
        yield
    finally:
        for m, b, w in old:
            m.BLOCKS, m.WIDTHS = b, w


def jax_init(seed: int = 0):
    """JAX's init_params at the BLOCKS and WIDTHS set now, jitted (one
    compile; JAX's draws, if not bit for bit the eager call's).  A new
    function each call: jit's cache would keep the widths of a trace
    made before they were set."""
    return jax.jit(lambda key: jr.init_params(key))(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def narrow():
    """JAX's narrow parameters (``jax_init`` at NARROW) and the port's
    copy of them, made once (a compile of JAX's init takes seconds)."""
    with width(*NARROW):
        jp = jax_init(0)
        return jp, tr.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("step,batch,kw", [
    (0, 16, {}), (7, 5, {}), (3, 4, dict(seed=11)),
    (2, 3, dict(shape=(8, 8, 3), classes=10))])
def test_synthetic_images_are_the_jax_images(step, batch, kw):
    got, want = (tdata.synthetic_images(step, batch, **kw),
                 jdata.synthetic_images(step, batch, **kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- parameters
def test_params_from_jax_is_bit_for_bit_and_checks_shapes(narrow):
    jp, tp = narrow
    with width(*NARROW):
        for (path, t), j in zip(leaves_with_paths(tp), jax.tree.leaves(jp)):
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        bad = jax.tree.map(np.asarray, jp)
        bad["block0_0"]["c2"] = bad["block0_0"]["c2"][:, :, :, :4]
        with pytest.raises(ValueError, match="block0_0/c2"):
            tr.params_from_jax(bad, device="cpu")
        del bad["block0_0"]["proj"]
        with pytest.raises(ValueError, match="proj"):
            tr.params_from_jax(bad, device="cpu")


def test_full_width_leaves_and_buckets_are_jax_s():
    shapes = jax.eval_shape(lambda key: jr.init_params(key),
                            jax.random.PRNGKey(0))
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(shapes)[0]]
    jleaves = jax.tree.leaves(shapes)
    ours = list(leaves_with_paths(tr.param_shapes()))
    assert [p for p, _ in ours] == jpaths
    assert [s for _, s in ours] == [tuple(x.shape) for x in jleaves]
    assert len(ours) == 161
    assert sum(x.size for x in jleaves) == 23_705_252
    layout = make_layout([(s, torch.float32) for _, s in ours])
    want = jax_make_layout(jleaves)
    assert layout.bounds == want.bounds and layout.sizes == want.sizes
    assert layout.n_buckets == 23
    assert layout.bounds[-1] == (23_068_672, 23_705_252)


def test_init_is_jax_s_distribution(narrow):
    """The same leaves as JAX's init, the ones and zeros exactly, each
    normal leaf's mean and standard deviation within INIT_SIGMAS of
    JAX's draws (at NARROW: 256 to 36,864 draws a leaf)."""
    with width(*NARROW):
        tp = tr.init_params(0, device="cpu")
    for (path, t), j in zip(leaves_with_paths(tp),
                            jax.tree.leaves(jax.tree.map(np.asarray,
                                                         narrow[0]))):
        t = t.numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if j.ndim == 1:                   # GroupNorm and head: 1 and 0
            np.testing.assert_array_equal(t, j, err_msg=str(path))
            continue
        s = (0.01 if path == ("head_w",)
             else np.sqrt(2.0 / np.prod(j.shape[:3])))
        n = j.size
        assert abs(t.mean() - j.mean()) <= INIT_SIGMAS * s * np.sqrt(2 / n)
        assert abs(t.std() - j.std()) <= INIT_SIGMAS * s / np.sqrt(n)
        assert abs(t.std() - s) <= INIT_SIGMAS * s / np.sqrt(2 * n), path


# -------------------------------------------------- conv and groupnorm
@pytest.mark.parametrize("h,w,k,stride", [
    (8, 8, 3, 1), (8, 8, 3, 2), (7, 9, 3, 2), (9, 7, 3, 1), (8, 8, 1, 2),
    (7, 7, 1, 2), (32, 32, 3, 2)])
def test_conv_matches_jax_same_padding(h, w, k, stride):
    rng = np.random.default_rng(h * 100 + w * 10 + stride)
    x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    wt = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jax.jit(jr.conv, static_argnums=2)(x, wt, stride))
    got = tr.conv(torch.from_numpy(x), torch.from_numpy(wt), stride).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CONV_RTOL * np.abs(want).max()


def test_groupnorm_matches_jax():
    rng = np.random.default_rng(5)
    x = (3 + 2 * rng.normal(size=(3, 5, 4, 16))).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jax.jit(jr.groupnorm)(x, s, b))
    got = tr.groupnorm(*(torch.from_numpy(a) for a in (x, s, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------- forward, loss and gradients
@pytest.mark.parametrize("hw", [8, 32])
def test_narrow_forward_loss_and_gradients_match_jax(narrow, hw):
    rng = np.random.default_rng(hw)
    images = rng.normal(size=(4, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 100, 4).astype(np.int32)
    jp, tp = narrow
    with width(*NARROW):
        logits = np.asarray(jax.jit(jr.forward)(jp, images))
        (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
            jr.loss_fn, has_aux=True))(jp, images, labels)
        got = tr.forward(tp, torch.from_numpy(images)).numpy()
        train = [t.detach().requires_grad_() for t in leaves(tp)]
        loss, acc = tr.loss_fn(unflatten(tp, train), torch.from_numpy(images),
                               torch.from_numpy(labels))
        grads = torch.autograd.grad(loss, train)
    np.testing.assert_allclose(got, logits, rtol=0,
                               atol=LOSS_RTOL * np.abs(logits).max())
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert acc.item() == float(jacc)
    for (path, _), g, j in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jgrads)):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, path
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max(),
                                   err_msg=str(path))


# ------------------------------------------------------- fig7a's step
def jax_fig7a(jparams, mode: str, steps: int, batch: int):
    """benchmarks/fig7a.py's RESNET_RUN step on a 1-device mesh: the
    losses of ``steps`` steps."""
    mesh = make_mesh((1,), ("data",))
    sync = JaxSyncConfig(mode=mode, axes=("data",), bits=8, block=2048,
                         error_layers=())

    def step(params, images, labels, key):
        (loss, acc), g = jax.value_and_grad(jr.loss_fn, has_aux=True)(
            params, images, labels)
        g, _ = jax_sync_gradients(g, sync, key, None)
        params = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
        return params, loss, acc

    sfn = jax.jit(jax.shard_map(step, mesh=mesh,
                                in_specs=(P(), P("data"), P("data"), P()),
                                out_specs=(P(), P(), P()), check_vma=False))
    losses, key = [], jax.random.PRNGKey(1)
    for s in range(steps):
        images, labels = jdata.synthetic_images(s, batch)
        key, sub = jax.random.split(key)
        jparams, loss, _ = sfn(jparams, jnp.asarray(images),
                               jnp.asarray(labels), sub)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("mode", ["psum", "optinc"])
def test_fig7a_step_matches_jax(narrow, mode):
    jp, tp = narrow
    with width(*NARROW):
        want = jax_fig7a(jp, mode, 3, 4)
        _, got, _ = LIB["run_steps"](tp, mode, 1, 3, 4, (32, 32, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_TOL)


# -------------------------------------------- 2 gloo ranks vs stacked
def test_two_gloo_ranks_are_two_stacked_peers_bit_for_bit(tmp_path):
    """fig7a's step in optinc at bits 8, 2 steps: 2 ranks (gloo, one
    thread each, spawned with torchrun's launch environment) against 2
    stacked peers on one thread: the losses and the updated parameters
    bit for bit."""
    spec = {"out": str(tmp_path), "ranks": RANKS, "steps": RANK_STEPS,
            "batch": 8, "narrow": NARROW}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", STEP_LIB + RANK_MAIN, json.dumps(spec)],
        cwd=ROOT, env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(RANKS), RANK=str(r),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(RANKS)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(RANKS)]
    torch.set_num_threads(1)              # the ranks' thread count
    with width(*NARROW):
        params, losses, _ = LIB["run_steps"](
            tr.init_params(0, device="cpu"), "optinc", RANKS, RANK_STEPS, 8,
            (32, 32, 3))
    for rc, log in _wait({"ranks": procs}, time.time() + SPAWN_TIMEOUT_S)[
            "ranks"]:
        assert rc == 0, log[-3000:]
    for r in range(RANKS):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["losses"].tolist() == losses
        for i, p in enumerate(leaves(params)):
            np.testing.assert_array_equal(got[str(i)], p.numpy())
