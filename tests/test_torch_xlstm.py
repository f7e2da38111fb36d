"""The xLSTM family (xlstm_125m) in the port on the CPU, held against the
JAX package on the same numpy-seeded inputs (weights carried across with
``params_from_jax``), at its SMOKE widths in f32 (4 layers, slstm_every
2: mLSTM, sLSTM, mLSTM, sLSTM; d 64; the mLSTM's d_inner 128 in 2 heads
of 64, the sLSTM's 2 heads of 32; vocab 128).

What is held:

* ``mlstm_block`` (JAX's): its output, final state {"c", "n"} and the
  gradients at t 64, at a ragged t (37, padded to the chunk) and at chunk
  16 over t 48 (three chunks, the state carried); at t 256 with chunk 128
  JAX's gradients are not finite (the reference's fault: its decay is
  ``where(mask, exp(rel), 0)`` and rel grows by about 0.69 a token),
  while the port's are finite and equal, within BLOCK_RTOL, to JAX's own
  block at chunk 32, the same function with no overflow;
* ``slstm_block`` with and without a carried state, and its loop's
  hand-written backward (``SLSTMScan``) against finite differences;
* the tree (``mlstm`` and ``slstm`` stacked), its specs, shapes, inits
  and the published widths' count against JAX's;
* the SMOKE ``loss_fn`` and every leaf's gradient at t 64; remat;
* one ``--sync optinc --bits 8`` step of 2 stacked peers against JAX's
  ``make_train_step`` on a 2-device data mesh, and a 2-rank gloo world
  of the same step against the stacked run, bit for bit; the CLI;
* serving: ``prefill_step`` and ``decode_step`` against JAX's, and
  ServeSession's greedy tokens against JAX's ServeSession for prompts of
  8 and 130 tokens (the chunk padded);
* the refusals: tp > 1 and ``--fsdp``, ServeEngine, the paged steps.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import api as japi
from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jconfigs
from repro.api import MeshSpec
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import ShardCtx as JCtx
from test_torch_processes import _env, _free_port, _wait
from test_torch_zamba import (JAX_SCRIPT, RANK_MAIN, assert_rel, jax_tp1,
                              to_torch, tree_of)
from repro_torch import api as tapi
from repro_torch.collectives.engine import SyncConfig
from repro_torch.configs import get
from repro_torch.launch import steps, train
from repro_torch.models import blocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.tree import leaves, leaves_with_paths, set_path, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm_125m"
SEED = 23
# a block's output, final state and gradients relative to each one's
# largest entry: the port computes the mLSTM's intra-chunk terms of all
# chunks at once and JAX in its scan, so their f32 sums run in other
# orders (they read up to 4.6e-6 at t 256)
BLOCK_RTOL = 1e-5
# the loss (O(5)) and each gradient leaf relative to its largest entry
GRAD_RTOL = 1e-4
STEP_TOL = 1e-4                     # a trainer step (test_torch_zamba's)
# serving logits and states relative to their largest entry
SERVE_RTOL = 1e-5
PEERS, ROWS, SEQ = 2, 2, 64
LR = 1e-3
SYNC_KW = dict(mode="optinc", bits=8, block=128, error_feedback=True,
               bucket_bytes=1 << 16)
# JAX's dp-2 step with error feedback on CPU host devices can pair one
# device's all-reduce with the other's reduce-scatter (ROADMAP queue 3):
# its oracle runs without; a zero residual leaves step 0 the same
JAX_SYNC_KW = dict(SYNC_KW, error_feedback=False)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)            # the gloo ranks' thread count
    yield
    torch.set_num_threads(old)


def cfg_pair():
    """(JAX config, port config) of xLSTM's SMOKE config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int) -> dict:
    """numpy params at JAX's shapes: norms 1, the rest normal * 0.1, so
    the gates spread (f ~ N(0, 0.8): about 0.77 of decay a token) and
    |n| passes 1, where the mLSTM's denominator leaves max(., 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        z = rng.standard_normal(shp).astype(np.float32)
        set_path(out, path, (1 + 0 * z if path[-1].endswith("norm")
                             else 0.1 * z).astype(np.float32))
    return out


def layer0(cfg, kind: str, seed: int) -> dict:
    return {k: v[0] for k, v in np_params(cfg, seed)[kind].items()}


def finite(tree) -> bool:
    return all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(tree))


# ------------------------------------------------------------ the blocks
def jax_mlstm(jcfg, p, x, w, chunk: int):
    """JAX's jitted mlstm_block at tp 1: out, final state and the
    gradients of sum(out w) with respect to the leaves and x."""
    def fn(p, x):
        def f(p, x):
            out, st = jblocks.mlstm_block(ctx, jcfg, p, x, chunk=chunk)
            return jnp.sum(out * w), (out, st)
        (_, (out, st)), g = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(p, x)
        return out, st, g
    call, ctx = jax_tp1(fn)
    out, st, (gp, gx) = call(p, jnp.asarray(x))
    return out, st, gp, gx


def port_block(block, cfg, p, x, w, **kw):
    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, st = block(cfg, tp, tx, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *tp.values()])
    return out.detach(), st, dict(zip(tp, grads[1:])), grads[0]


def block_inputs(cfg, t: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, cfg.d_model)).astype(np.float32),
            rng.standard_normal((2, t, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("t,chunk", [(64, 128), (37, 128), (48, 16)],
                         ids=["t64", "ragged", "chunks"])
def test_mlstm_block_matches_jax(t, chunk):
    """mlstm_block (layer 0 of the SMOKE stack): the output, the final
    C (b, 2, 64, 64) and n (b, 2, 64), and the gradients of sum(out w)
    with respect to x and every leaf, against JAX's at tp 1."""
    jcfg, cfg = cfg_pair()
    p = layer0(cfg, "mlstm", SEED)
    x, w = block_inputs(cfg, t, SEED + t)
    jout, jst, jgp, jgx = jax_mlstm(jcfg, p, x, w, chunk)
    out, st, gp, gx = port_block(blocks.mlstm_block, cfg, p, x, w,
                                 chunk=chunk)
    assert st["c"].shape == (2, 2, 64, 64) and st["n"].shape == (2, 2, 64)
    assert_rel(out.numpy(), jout, BLOCK_RTOL, "out")
    for k in ("c", "n"):
        assert_rel(st[k].detach().numpy(), jst[k], BLOCK_RTOL, k)
    assert_rel(gx.numpy(), jgx, BLOCK_RTOL, "dx")
    for k, g in gp.items():
        assert np.abs(np.asarray(jgp[k])).max() > 0, k
        assert_rel(g.numpy(), jgp[k], BLOCK_RTOL, k)


def test_long_chunks_repair_the_references_nan_gradient():
    """t 256 with chunk 128: above the diagonal a chunk's decay exponent
    reaches ~98 here (past f32's exp overflow at 88.72), so JAX's own
    block has non-finite gradients (pinned: the reference's fault) and
    finite ones at chunk 32; the port's at chunk 128 are finite and equal
    JAX's at chunk 32 within BLOCK_RTOL, and its output is JAX's
    chunk-128 output."""
    jcfg, cfg = cfg_pair()
    p = layer0(cfg, "mlstm", SEED + 1)
    x, w = block_inputs(cfg, 256, SEED + 2)
    jout, _, jgp, jgx = jax_mlstm(jcfg, p, x, w, 128)
    assert np.isfinite(np.asarray(jout)).all()
    assert not finite((jgp, jgx))
    jout32, jst32, jgp32, jgx32 = jax_mlstm(jcfg, p, x, w, 32)
    assert finite((jgp32, jgx32))
    out, st, gp, gx = port_block(blocks.mlstm_block, cfg, p, x, w,
                                 chunk=128)
    assert_rel(out.numpy(), jout, BLOCK_RTOL, "out")
    assert_rel(out.numpy(), jout32, BLOCK_RTOL, "out chunk 32")
    for k in ("c", "n"):
        assert_rel(st[k].detach().numpy(), jst32[k], BLOCK_RTOL, k)
    assert np.isfinite(gx.numpy()).all()
    assert_rel(gx.numpy(), jgx32, BLOCK_RTOL, "dx")
    for k, g in gp.items():
        assert np.isfinite(g.numpy()).all(), k
        assert_rel(g.numpy(), jgp32[k], BLOCK_RTOL, k)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
def test_slstm_block_matches_jax(carried):
    """slstm_block (layer 0) over t 24: the output and the gradients of
    sum(out w); with a carried state {"h", "c", "n", "m"} also the final
    state (without one both return None, as JAX's training forward)."""
    jcfg, cfg = cfg_pair()
    p = layer0(cfg, "slstm", SEED + 3)
    x, w = block_inputs(cfg, 24, SEED + 4)
    rng = np.random.default_rng(SEED + 5)
    st0 = {k: rng.standard_normal((2, 2, 32)).astype(np.float32)
           for k in ("h", "c", "n", "m")}
    st0["n"] = np.abs(st0["n"]) + 0.5
    state = ({k: jnp.asarray(v) for k, v in st0.items()} if carried
             else None)

    def fn(p, x):
        def f(p, x):
            out, st = jblocks.slstm_block(ctx, jcfg, p, x, state=state)
            return jnp.sum(out * w), (out, st)
        (_, (out, st)), g = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(p, x)
        return out, st, g
    call, ctx = jax_tp1(fn)
    jout, jst, (jgp, jgx) = call(p, jnp.asarray(x))
    out, st, gp, gx = port_block(
        blocks.slstm_block, cfg, p, x, w,
        state={k: torch.from_numpy(v) for k, v in st0.items()}
        if carried else None)
    assert_rel(out.numpy(), jout, BLOCK_RTOL, "out")
    assert_rel(gx.numpy(), jgx, BLOCK_RTOL, "dx")
    for k, g in gp.items():
        assert np.abs(np.asarray(jgp[k])).max() > 0, k
        assert_rel(g.numpy(), jgp[k], BLOCK_RTOL, k)
    if not carried:
        assert st is None and jst is None
        return
    for k in ("h", "c", "n", "m"):
        assert_rel(st[k].detach().numpy(), jst[k], BLOCK_RTOL, k)


def test_slstm_scan_backward_passes_gradcheck():
    """SLSTMScan's hand-written backward against finite differences in
    f64 (``torch.autograd.gradcheck``, its default tolerances) at t 6,
    2 heads of 3, batch 2, through all four outputs (every step's h, c,
    n and m); the carried n starts above 1 and m at random, so no
    maximum sits at a tie, where the two sides differ."""
    rng = np.random.default_rng(SEED + 6)

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale + shift)
    gates = arr(6, 2, 2, 12).requires_grad_()
    r = arr(2, 3, 3, scale=0.5).requires_grad_()
    init = (arr(2, 2, 3), arr(2, 2, 3), arr(2, 2, 3).abs() + 1.5,
            arr(2, 2, 3))
    assert torch.autograd.gradcheck(
        lambda g, w: blocks.SLSTMScan.apply(g, w, *init), (gates, r))


# ------------------------------------------------------------ the tree
def test_published_widths():
    """xlstm_125m at its published widths (arXiv:2405.04517: 12 layers,
    d 768, 4 heads, vocab 50304, one sLSTM in every 4): 9 mLSTM layers
    of d_inner 1536 in 4 heads of 384, 3 sLSTM layers of 4 heads of 192;
    14 leaves, 139,706,112 parameters, JAX's ``param_shape_dtype``
    shapes (``ModelConfig.param_count`` is JAX's approximation, 8 d^2 a
    layer: 133,890,048)."""
    cfg = get(ARCH)
    shapes = tlm.param_shapes(cfg)
    assert len(leaves(shapes)) == 14
    assert sum(math.prod(s) for s in leaves(shapes)) == 139_706_112
    assert shapes["mlstm"]["w_q"] == (9, 768, 1536)
    assert shapes["mlstm"]["w_if"] == (9, 768, 8)
    assert shapes["slstm"]["r"] == (3, 4, 192, 192)
    assert cfg.param_count() == 133_890_048
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jlm.param_shape_dtype(
        jconfigs.get(ARCH), JCtx()))
    assert jshapes == shapes


@pytest.mark.parametrize("tp,fsdp", [(1, False), (2, False), (2, True)])
def test_tree_and_specs_are_jaxs(tp, fsdp):
    """The SMOKE tree's specs, shapes and leaf order are JAX's on every
    mesh."""
    jcfg, cfg = cfg_pair()
    jspecs, jshapes = jlm.param_specs(jcfg, JCtx(tp=tp, dp=2, fsdp=fsdp))
    specs, shapes = tlm.param_specs(cfg, ShardCtx(tp=tp, dp=2, fsdp=fsdp))
    assert shapes == jshapes
    want = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    assert [tuple(s) for s in leaves(specs)] == [tuple(s) for s in want]
    assert [p for p, _ in leaves_with_paths(shapes)] == [
        tuple(k.key for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(
            jshapes, is_leaf=lambda x: isinstance(x, tuple))[0]]


def test_params_from_jax_and_init_follow_jax():
    """JAX's bf16 init carried across bit for bit (14 leaves); the
    port's seeded init has JAX's shapes, norms 1, and ``r`` and the
    projections drawn at 0.02 (fan-in 32 and 64)."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfg_pair())
    jparams = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jsteps.make_ctx(MeshSpec().build()), jax.random.PRNGKey(2)))
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    assert len(leaves(params)) == 14
    for path, t in leaves_with_paths(params):
        want = jparams
        for k in path:
            want = want[k]
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    a = tlm.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == jax.tree.map(
        lambda t: tuple(t.shape), a)
    for kind in ("mlstm", "slstm"):
        assert torch.all(a[kind]["norm"] == 1), kind
        assert np.all(jparams[kind]["norm"].astype(np.float32) == 1), kind
    for leaf in (a["slstm"]["r"], a["mlstm"]["w_q"]):
        assert abs(leaf.float().std().item() - 0.02) < 2e-3


# ------------------------------------------------ loss and gradients
def _port_loss_and_grads(cfg, p, tokens, ctx=ShardCtx()):
    params = to_torch(p)
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, unflatten(params, train_),
                          {"tokens": torch.from_numpy(tokens)}, ctx)
    return loss, torch.autograd.grad(loss, train_), params


def test_loss_and_gradients_match_jax():
    """loss_fn of the trunk (mLSTM, sLSTM, mLSTM, sLSTM) and every leaf's
    gradient against JAX's jitted loss_fn, t 64."""
    jcfg, cfg = cfg_pair()
    p = np_params(cfg, SEED + 6)
    tokens = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (3, SEQ + 1)).astype(np.int32)
    mesh = MeshSpec().build()
    ctx = jsteps.make_ctx(mesh)
    specs = jlm.flat_specs(jcfg, ctx)

    def f(p, t):
        return jax.value_and_grad(lambda p: jlm.loss_fn(
            jcfg, ctx, p, {"tokens": t}), has_aux=True)(p)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, P()),
                               out_specs=((P(), {"nll": P()}), specs),
                               check_vma=False))
    with jax.set_mesh(mesh):
        (jloss, _), jgrads = fn(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(tokens))
    loss, grads, params = _port_loss_and_grads(cfg, p, tokens)
    assert abs(loss.item() - float(jloss)) <= STEP_TOL
    for (path, _), g in zip(leaves_with_paths(params), grads):
        want = np.asarray(jgrads[path[0]] if len(path) == 1
                          else jgrads[path[0]][path[1]])
        assert g.shape == want.shape and np.abs(want).max() > 0, path
        assert_rel(g.numpy(), want, GRAD_RTOL, str(path))


@pytest.mark.parametrize("groups", [1, 2])
def test_remat_equals_no_remat(groups):
    """Checkpointing every mLSTM layer and every group (remat_groups >
    0, JAX's ``ckpt``) changes no number: the loss and every gradient
    bit for bit."""
    _, cfg = cfg_pair()
    p = np_params(cfg, SEED + 8)
    tokens = np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab, (2, 33)).astype(np.int32)
    loss, grads, _ = _port_loss_and_grads(cfg, p, tokens)
    rloss, rgrads, _ = _port_loss_and_grads(cfg, p, tokens,
                                            ShardCtx(remat_groups=groups))
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))


# ------------------------------------------------------------ trainers
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dp-2 trainer (one subprocess, 2 host devices) and the port's
    2-rank gloo world of the same step, spawned together."""
    d = tmp_path_factory.mktemp("xlstm")
    _, cfg = cfg_pair()
    inp = {"params/" + "/".join(path): a for path, a in
           leaves_with_paths(np_params(cfg, SEED + 10))}
    inp["tokens"] = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (PEERS * ROWS, SEQ + 1)).astype(np.int32)
    np.savez(d / "in.npz", **inp)
    spec = {"arch": ARCH, "peers": PEERS, "sync_kw": JAX_SYNC_KW, "lr": LR}
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={PEERS}")
    env.pop("OMP_NUM_THREADS")
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "jax_out.npz"), json.dumps(spec)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)]}
    port = _free_port()
    procs["gloo"] = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, json.dumps(
            {**spec, "sync_kw": SYNC_KW, "inputs": str(d / "in.npz"),
             "out": str(d)})],
        cwd=ROOT, env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(PEERS), RANK=str(r),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(PEERS)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(PEERS)]
    res = _wait(procs, time.time() + SPAWN_TIMEOUT_S)
    for name, group in res.items():
        for rc, log in group:
            assert rc == 0, f"{name}: {log[-4000:]}"
    return dict(inp=inp, jax=dict(np.load(d / "jax_out.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz"))
                       for r in range(PEERS)])


def _stacked_run(inp: dict, sync_kw: dict, steps_: int):
    """The port's trainer with PEERS stacked peers: (losses, params)."""
    _, cfg = cfg_pair()
    sync, opt = SyncConfig(**sync_kw), AdamWConfig(lr=LR)
    params = to_torch(tree_of(inp, "params/"))
    ostate = adamw_init(opt, params)
    sstate = steps.init_sync_state(cfg, PEERS, sync, "cpu")
    step = steps.make_train_step(cfg, PEERS, sync, opt, "cpu")
    losses = []
    for _ in range(steps_):
        params, ostate, sstate, m = step(params, ostate, sstate,
                                         torch.from_numpy(inp["tokens"]))
        losses.append(m["loss"])
    return torch.stack(losses), params


def test_stacked_step_matches_jax_make_train_step(runs):
    """One --sync optinc --bits 8 step of 2 stacked peers against JAX's
    make_train_step on a 2-device data mesh: the loss, and every
    parameter after it."""
    losses, params = _stacked_run(runs["inp"], JAX_SYNC_KW, 1)
    assert abs(losses[0].item() - float(runs["jax"]["loss"])) <= STEP_TOL
    for path, t in leaves_with_paths(params):
        assert_rel(t.numpy(), runs["jax"]["params/" + "/".join(path)],
                   STEP_TOL, str(path))


def test_gloo_ranks_equal_the_stacked_run_bit_for_bit(runs):
    """A 2-rank gloo world (one peer a process, error feedback on) gives
    the stacked run's losses of two steps and its parameters bit for bit
    on every rank."""
    losses, params = _stacked_run(runs["inp"], SYNC_KW, 2)
    for rank in runs["ranks"]:
        assert np.array_equal(np.stack([rank["loss0"], rank["loss1"]]),
                              losses.numpy())
        for path, t in leaves_with_paths(params):
            assert np.array_equal(rank["params/" + "/".join(path)],
                                  t.numpy()), path


def test_cli_trains_the_smoke_config(capsys):
    """The training CLI (RunSpec -> TrainSession) takes xlstm_125m:
    stacked peers, finite losses that fall."""
    assert train.main(["--device", "cpu", "--arch", ARCH, "--smoke-config",
                       "--sync", "optinc", "--mesh", "2x1", "--steps", "6",
                       "--global-batch", "4", "--seq-len", "32", "--lr",
                       "3e-3"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ------------------------------------------------------------- serving
def _serve_pair(seed: int):
    """JAX's f32 init of the SMOKE config and the same weights here."""
    jcfg, cfg = cfg_pair()
    jparams = jlm.init_params(jcfg, JCtx(), jax.random.PRNGKey(seed))
    return jparams, cfg, tlm.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def test_serving_steps_match_jax():
    """prefill_step over a ragged prompt (t 37: the chunk padded) and two
    decode steps from its state, against JAX's prefill_step and
    decode_step: the logits and every leaf of the recurrent state
    ({"mlstm": {"c", "n"}, "slstm": {"h", "c", "n", "m"}}, stacked on
    the layer axis), within SERVE_RTOL of each one's largest entry."""
    jcfg, cfg = cfg_pair()
    p = np_params(cfg, SEED + 12)
    rng = np.random.default_rng(SEED + 13)
    prompt = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 2, 1)).astype(np.int32)

    def fn(p, prompt, toks):
        logits, cache = jlm.prefill_step(jcfg, ctx, p, prompt)
        outs = [(logits, cache)]
        for i in range(toks.shape[0]):
            logits, cache = jlm.decode_step(jcfg, ctx, p, cache, toks[i],
                                            jnp.int32(37 + i))
            outs.append((logits, cache))
        return outs
    call, ctx = jax_tp1(fn)
    want = call(jax.tree.map(jnp.asarray, p), jnp.asarray(prompt),
                jnp.asarray(toks))
    params = to_torch(p)
    with torch.inference_mode():
        got = [tlm.prefill_step(cfg, params, torch.from_numpy(prompt).long())]
        for i in range(toks.shape[0]):
            got.append(tlm.decode_step(cfg, params, got[-1][1],
                                       torch.from_numpy(toks[i]).long(),
                                       37 + i))
    empty = tlm.init_cache(cfg, 2, 64, "cpu")
    for (logits, cache), (jlogits, jcache) in zip(got, want):
        assert logits.shape == (2, cfg.vocab)
        assert_rel(logits.numpy(), jlogits, SERVE_RTOL, "logits")
        for path, t in leaves_with_paths(cache):
            ref = jcache[path[0]][path[1]]
            assert t.shape == ref.shape == empty[path[0]][path[1]].shape, path
            assert t.dtype == torch.float32
            assert_rel(t.numpy(), ref, SERVE_RTOL, str(path))
    assert torch.all(empty["slstm"]["m"] == -30)


@pytest.mark.parametrize("prompt_len", [8, 130])
def test_serve_session_generate_matches_jax(prompt_len):
    """ServeSession.generate (lm.prefill_step, then lm.decode_step from
    the prefill's state) against JAX's ServeSession on the same f32
    weights: the greedy tokens, equal; 130 tokens pad the mLSTM's chunk
    of 128 to two."""
    jparams, cfg, params = _serve_pair(SEED + 14)
    prompts = np.random.default_rng(SEED + prompt_len).integers(
        0, cfg.vocab, (2, prompt_len))
    sess = tapi.ServeSession(tapi.RunSpec(arch=ARCH, smoke=True),
                             params=params, device="cpu", cfg=cfg)
    jsess = japi.ServeSession(japi.RunSpec(arch=ARCH, smoke=True),
                              params=jparams)
    want = np.asarray(jsess.generate(prompts, gen_len=6))
    got = sess.generate(prompts, gen_len=6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    logits, state = sess.prefill(prompts)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert state["mlstm"]["c"].shape == (2, 2, 2, 64, 64)
    cache = sess.new_cache(2, 64)
    assert cache["slstm"]["h"].shape == (2, 2, 2, 32)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("ctx,match", [
    (ShardCtx(tp=2), "tensor parallelism"),
    (ShardCtx(dp=2, fsdp=True), "--fsdp"),
], ids=["tp2", "fsdp"])
def test_make_train_step_refuses_sharding(ctx, match):
    _, cfg = cfg_pair()
    with pytest.raises(NotImplementedError, match=f"{match}.*ssm family"):
        steps.make_train_step(cfg, 2, SyncConfig(), AdamWConfig(), "cpu",
                              ctx=ctx)


def test_paged_serving_refuses_xlstm():
    """ServeEngine (paged, continuous batching) refuses xLSTM, as JAX's
    engine does; so do the paged steps, naming the contiguous ones, as
    they name them for whisper, whose contiguous cache (once refused
    here) is JAX's self and cross caches."""
    _, cfg = cfg_pair()
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(cfg, ServeConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="lm.prefill_step"):
        tlm.batched_prefill_step(cfg, {}, torch.zeros((1, 4),
                                                      dtype=torch.long),
                                 torch.ones(1))
    whisper = get("whisper_tiny")
    with pytest.raises(NotImplementedError, match="contiguous steps"):
        tlm.paged_decode_step(whisper, {}, {}, None, None, None)
    assert set(tlm.init_cache(whisper, 1, 16, "cpu")) == {"self", "cross"}
