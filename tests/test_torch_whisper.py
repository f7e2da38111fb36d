"""The encoder-decoder family of the port (whisper_tiny) on the CPU, held
against the JAX package on the same numpy-seeded inputs (weights carried
across with ``params_from_jax``), at its SMOKE widths in f32 (2 encoder
and 2 decoder layers, d 64, 2 heads of 32, 32 frames).

What is held:

* the enc-dec parameter tree (``encoder``, ``decoder`` with the
  cross-attention's ``x_`` leaves): ``params_from_jax`` bit for bit,
  ``init_params``' recipe;
* ``loss_fn`` on a batch that carries ``enc_frames`` (the encoder's
  non-causal flash, the decoder's causal self-attention and its
  non-causal cross-attention over the encoder's K/V) and its gradients,
  against JAX's jitted ``loss_fn`` and ``value_and_grad``;
* two ``--sync optinc --bits 8`` steps of ``make_train_step`` with 2
  stacked peers against JAX's ``make_train_step`` on a 2-device mesh
  (one module-scoped JAX subprocess), and a 2-rank gloo world of the
  same step against the stacked run, bit for bit;
* the refusals: ``--fsdp`` (the reference cannot run it), tp > 1 (not
  ported yet) and the training sessions (JAX's trainer feeds no
  ``enc_frames``); serving takes it (``test_torch_whisper_serve.py``)
  on the contiguous steps, and the paged steps refuse it.
"""
import dataclasses
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
from repro import configs as jconfigs
from repro.api import MeshSpec
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from test_torch_processes import _env, _free_port, _wait
from repro_torch import api as tapi
from repro_torch.collectives.engine import SyncConfig
from repro_torch.configs import get
from repro_torch.launch import steps, train
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.tree import leaves, leaves_with_paths, set_path, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_tiny"
# the f32 loss (O(5)) and each gradient leaf relative to its largest
# entry, and the trainer's losses: f32 sums in other orders, a few ulp
STEP_TOL = 1e-4
SEED = 7
PEERS, ROWS, SEQ = 2, 2, 37          # t 37: ragged against every tile
TRAIN_STEPS = 2
SYNC_KW = dict(mode="optinc", bits=8, block=128, error_feedback=True,
               bucket_bytes=1 << 16)
# the JAX oracle's trainer runs without error feedback: with it, JAX's
# dp-2 step on this tree, on two CPU host devices, pairs one device's
# all-reduce with the other's reduce-scatter (XLA's rendezvous reports
# it): it hangs, or its step 0 differs from run to run by update signs
# in ~1,500 elements of a leaf.  Without feedback it repeats, and the
# port's step 0 is bit-equal with feedback on and off (a zero residual)
JAX_SYNC_KW = dict(SYNC_KW, error_feedback=False)
LR = 1e-3
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfg_pair():
    """(JAX config, port config) of whisper's SMOKE config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int) -> dict:
    """numpy params at JAX's shapes: normal * 0.02, norms 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        a = (np.ones(shp, np.float32) if path[-1].endswith("norm") else
             rng.standard_normal(shp).astype(np.float32) * 0.02)
        set_path(out, path, a)
    return out


def np_batch(cfg, seed: int, steps_: int = 1) -> list:
    """``steps_`` batches of PEERS * ROWS rows: tokens (B, SEQ + 1) and
    enc_frames (B, frames, d)."""
    rng = np.random.default_rng(seed)
    b = PEERS * ROWS
    return [{"tokens": rng.integers(0, cfg.vocab, (b, SEQ + 1)
                                    ).astype(np.int32),
             "enc_frames": rng.standard_normal(
                 (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
            for _ in range(steps_)]


def to_torch(tree) -> dict:
    return unflatten(tree, [torch.from_numpy(np.array(a))
                            for a in leaves(tree)])


def _tree(flat: dict, prefix: str) -> dict:
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            set_path(out, tuple(k[len(prefix):].split("/")), v)
    return out


def assert_rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ------------------------------------------- the module's JAX oracle
JAX_SCRIPT = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat  # noqa: F401
    from repro import configs
    from repro.api import MeshSpec
    from repro.collectives import SyncConfig
    from repro.launch import steps as js
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init

    inp = dict(np.load(sys.argv[1]))
    spec = json.loads(sys.argv[3])
    cfg = dataclasses.replace(configs.get_smoke(spec["arch"]),
                              dtype="float32")
    params = {}
    for k, v in inp.items():
        if k.startswith("params/"):
            node = params
            parts = k[len("params/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)

    def batch(i):
        return {"tokens": jnp.asarray(inp[f"tokens{i}"]),
                "enc_frames": jnp.asarray(inp[f"enc_frames{i}"])}

    out = {}
    one = MeshSpec().build()
    ctx = js.make_ctx(one)
    specs = lm.flat_specs(cfg, ctx)

    def f(p, b):
        return jax.value_and_grad(lambda p: lm.loss_fn(cfg, ctx, p, b),
                                  has_aux=True)(p)
    fn = jax.jit(jax.shard_map(
        f, mesh=one, in_specs=(specs, {"tokens": P(), "enc_frames": P()}),
        out_specs=((P(), {"nll": P()}), specs), check_vma=False))
    with jax.set_mesh(one):
        (loss, aux), grads = fn(params, batch(0))
    out["loss"] = np.asarray(loss)
    out["nll"] = np.asarray(aux["nll"])
    for path, a in jax.tree_util.tree_leaves_with_path(grads):
        out["grads/" + "/".join(p.key for p in path)] = np.asarray(a)

    ms = MeshSpec(dp=spec["peers"])
    mesh = ms.build()
    specs = lm.flat_specs(cfg, ms.ctx())
    scfg = SyncConfig(axes=("data",), **spec["sync_kw"])
    opt = AdamWConfig(lr=spec["lr"])
    step = jax.jit(js.make_train_step(cfg, mesh, scfg, opt)[0])

    def put(specs, t):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), t, specs,
            is_leaf=lambda x: isinstance(x, P))
    p = put(specs, params)
    ostate = put(js.opt_specs(specs), adamw_init(opt, p))
    sstate = put(js.sync_state_specs(mesh, scfg),
                 js.init_sync_state(cfg, mesh, scfg))
    with jax.set_mesh(mesh):
        for i in range(spec["steps"]):
            p, ostate, sstate, m = step(p, ostate, sstate, batch(i),
                                        jax.random.PRNGKey(i))
            out[f"train/loss{i}"] = np.asarray(m["loss"])
            if i == 0:
                for path, a in jax.tree_util.tree_leaves_with_path(p):
                    out["train/params/" + "/".join(q.key for q in path)] = (
                        np.asarray(a))
    np.savez(sys.argv[2], **out)
''')

# one rank of the gloo world: the port's make_train_step with ``world``
RANK_MAIN = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.configs import get_smoke
    from repro_torch.launch import distributed, steps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves, leaves_with_paths, set_path

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(spec["inputs"]))
    world = distributed.init(1, spec["peers"], 1, "cpu",
                             datetime.timedelta(seconds=200))
    cfg = dataclasses.replace(get_smoke(spec["arch"]), dtype="float32")
    params = {}
    for k, v in inp.items():
        if k.startswith("params/"):
            set_path(params, tuple(k[len("params/"):].split("/")),
                     torch.from_numpy(v))
    sync = SyncConfig(**spec["sync_kw"])
    opt = AdamWConfig(lr=spec["lr"])
    step = steps.make_train_step(cfg, spec["peers"], sync, opt, "cpu",
                                 world=world)
    ostate = adamw_init(opt, params)
    sstate = steps.init_sync_state(cfg, 1, sync, "cpu")
    out = {}
    for i in range(spec["steps"]):
        params, ostate, sstate, m = step(
            params, ostate, sstate, torch.from_numpy(inp[f"tokens{i}"]),
            enc_frames=torch.from_numpy(inp[f"enc_frames{i}"]))
        out[f"loss{i}"] = m["loss"].numpy()
    for path, t in leaves_with_paths(params):
        out["params/" + "/".join(path)] = t.numpy()
    np.savez(os.path.join(spec["out"], f"rank{world.rank}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (loss and gradients on one device, the trainer on a
    2-device data mesh; one subprocess) and the port's 2-rank gloo world
    of the same trainer, spawned together."""
    d = tmp_path_factory.mktemp("whisper")
    _, cfg = cfg_pair()
    inp = {"params/" + "/".join(path): a
           for path, a in leaves_with_paths(np_params(cfg, SEED))}
    for i, b in enumerate(np_batch(cfg, SEED + 1, TRAIN_STEPS)):
        inp[f"tokens{i}"], inp[f"enc_frames{i}"] = b["tokens"], b[
            "enc_frames"]
    np.savez(d / "in.npz", **inp)
    spec = {"arch": ARCH, "peers": PEERS, "sync_kw": JAX_SYNC_KW, "lr": LR,
            "steps": TRAIN_STEPS}
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


def _stacked_run(inp: dict, sync_kw: dict, steps_: int = TRAIN_STEPS):
    """The port's trainer with PEERS stacked peers on the runs' inputs,
    on one thread (as the gloo ranks): (the losses of ``steps_`` steps,
    the params after them)."""
    _, cfg = cfg_pair()
    sync, opt = SyncConfig(**sync_kw), AdamWConfig(lr=LR)
    params = to_torch(_tree(inp, "params/"))
    ostate = adamw_init(opt, params)
    sstate = steps.init_sync_state(cfg, PEERS, sync, "cpu")
    step = steps.make_train_step(cfg, PEERS, sync, opt, "cpu")
    losses = []
    torch.set_num_threads(1)
    for i in range(steps_):
        params, ostate, sstate, m = step(
            params, ostate, sstate, torch.from_numpy(inp[f"tokens{i}"]),
            enc_frames=torch.from_numpy(inp[f"enc_frames{i}"]))
        losses.append(m["loss"])
    return torch.stack(losses), params


# ---------------------------------------------------------- parameters
@pytest.mark.parametrize("tp,fsdp", [(1, False), (2, False), (1, True)])
def test_config_and_tree_are_jaxs(tp, fsdp):
    """The published widths' tree (26 leaves, 61,074,048 parameters); the
    SMOKE tree's specs, shapes and leaf order are JAX's on every mesh."""
    import math
    from repro.models.layers import ShardCtx as JCtx
    full = tlm.param_shapes(get(ARCH))
    assert len(leaves(full)) == 26
    assert sum(math.prod(s) for s in leaves(full)) == 61_074_048
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
    assert set(shapes["decoder"]) == {
        "norm", "wq", "wk", "wv", "wo", "x_norm", "x_wq", "x_wk", "x_wv",
        "x_wo", "mlp_norm", "w_gate", "w_up", "w_down"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    jcfg, cfg = cfg_pair()
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jparams = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jsteps.make_ctx(MeshSpec().build()), jax.random.PRNGKey(1)))
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    for path, t in leaves_with_paths(params):
        want = jparams
        for k in path:
            want = want[k]
        got = t.view(torch.int16) if dtype == "bfloat16" else t
        ref = (np.asarray(want).view(np.int16) if dtype == "bfloat16"
               else np.asarray(want))
        assert np.array_equal(got.numpy(), ref), path


def test_init_params_follows_the_jax_recipe():
    """Norms (x_norm too) are 1, the matrices normal * 0.02, and the
    shapes are JAX's init_params'."""
    jcfg, cfg = cfg_pair()
    jp = jlm.init_params(jcfg, jsteps.make_ctx(MeshSpec().build()),
                         jax.random.PRNGKey(0))
    a = tlm.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == jax.tree.map(
        lambda t: tuple(t.shape), a)
    for stack in ("encoder", "decoder"):
        for k, t in a[stack].items():
            if k.endswith("norm"):
                assert torch.all(t == 1), (stack, k)
                assert np.all(np.asarray(jp[stack][k]) == 1), (stack, k)
            else:
                assert abs(t.std().item() - 0.02) < 2e-3, (stack, k)
    assert torch.equal(a["decoder"]["x_wk"], tlm.init_params(
        cfg, seed=3, device="cpu")["decoder"]["x_wk"])


# ------------------------------------------------ loss and gradients
def test_loss_and_gradients_match_jax(runs):
    """loss_fn on tokens and enc_frames, and every leaf's gradient,
    against JAX's jitted loss_fn and value_and_grad."""
    _, cfg = cfg_pair()
    params = to_torch(_tree(runs["inp"], "params/"))
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, aux = tlm.loss_fn(cfg, unflatten(params, train_), {
        "tokens": torch.from_numpy(runs["inp"]["tokens0"]),
        "enc_frames": torch.from_numpy(runs["inp"]["enc_frames0"])})
    grads = torch.autograd.grad(loss, train_)
    jout = runs["jax"]
    assert abs(loss.item() - float(jout["loss"])) <= STEP_TOL
    assert abs(aux["nll"].item() - float(jout["nll"])) <= STEP_TOL
    for (path, _), g in zip(leaves_with_paths(params), grads):
        want = jout["grads/" + "/".join(path)]
        assert g.shape == want.shape and np.abs(want).max() > 0, path
        assert_rel(g.numpy(), want, STEP_TOL, str(path))


def test_forward_runs_both_flash_modes_and_needs_the_frames():
    """The encoder and the cross-attention run the flash pair's
    non-causal mode, the decoder's self-attention the causal one (a CPU
    run counts no launch: the plain versions run); the forward refuses a
    batch without enc_frames."""
    from repro_torch.kernels import attention, ref
    _, cfg = cfg_pair()
    params = to_torch(np_params(cfg, SEED))
    b = np_batch(cfg, SEED)[0]
    seen = []
    fwd = ref.attention_fwd_ref

    def spy(q, k, v, causal=True):
        seen.append((causal, q.shape[2], k.shape[2]))
        return fwd(q, k, v, causal)
    before = dict(attention.flash_attention.launches_by_mode)
    try:
        ref.attention_fwd_ref = spy
        tlm.forward_lm(cfg, params, torch.from_numpy(b["tokens"][:, :-1]),
                       enc_frames=torch.from_numpy(b["enc_frames"]))
    finally:
        ref.attention_fwd_ref = fwd
    t, te = SEQ, cfg.enc_frames
    assert seen == ([(False, te, te)] * cfg.n_enc_layers
                    + [(True, t, t), (False, t, te)] * cfg.n_layers)
    assert attention.flash_attention.launches_by_mode == before
    with pytest.raises(ValueError, match="enc_frames"):
        tlm.forward_lm(cfg, params, torch.from_numpy(b["tokens"]))


# ------------------------------------------------------------ trainers
def test_stacked_trainer_matches_jax_make_train_step(runs):
    """--sync optinc --bits 8 steps of 2 stacked peers, each on its rows
    of the tokens and the frames, against JAX's make_train_step on a
    2-device data mesh: the parameters after one step, and the losses of
    two (the second step's update moves by AdamW's second moment, where
    the two frameworks' last bits part)."""
    losses, _ = _stacked_run(runs["inp"], JAX_SYNC_KW)
    want = [float(runs["jax"][f"train/loss{i}"]) for i in range(TRAIN_STEPS)]
    np.testing.assert_allclose(losses.numpy(), want, rtol=0, atol=STEP_TOL)
    _, params = _stacked_run(runs["inp"], JAX_SYNC_KW, 1)
    for path, t in leaves_with_paths(params):
        assert_rel(t.numpy(), runs["jax"]["train/params/" + "/".join(path)],
                   STEP_TOL, str(path))


def test_gloo_ranks_equal_the_stacked_run_bit_for_bit(runs):
    """A 2-rank gloo world (one peer a process, the same step with
    ``world``, error feedback on) gives the stacked run's losses and
    parameters bit for bit on every rank."""
    losses, params = _stacked_run(runs["inp"], SYNC_KW)
    for rank in runs["ranks"]:
        assert np.array_equal(
            np.stack([rank[f"loss{i}"] for i in range(TRAIN_STEPS)]),
            losses.numpy())
        for path, t in leaves_with_paths(params):
            assert np.array_equal(rank["params/" + "/".join(path)],
                                  t.numpy()), path


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("ctx,err,match", [
    (ShardCtx(dp=2, fsdp=True), ValueError, "reference cannot run it"),
    (ShardCtx(tp=2), NotImplementedError, "not ported at tp > 1"),
], ids=["fsdp", "tp2"])
def test_make_train_step_refuses_what_is_not_run(ctx, err, match):
    _, cfg = cfg_pair()
    with pytest.raises(err, match=match):
        steps.make_train_step(cfg, 2, SyncConfig(), AdamWConfig(), "cpu",
                              ctx=ctx)


@pytest.mark.parametrize("session", ["TrainSession", "RunSpec"])
def test_sessions_refuse_the_enc_dec_family(session):
    """JAX's trainer feeds tokens only: TrainSession refuses a whisper
    RunSpec by name, with the entry point that trains it; the spec
    itself validates, as JAX's does (ServeSession serves it), and the
    train CLI refuses it too."""
    spec = tapi.RunSpec(arch=ARCH, smoke=True)
    if session == "RunSpec":
        assert spec.validate() is spec
        with pytest.raises(SystemExit, match="no enc_frames.*make_train_"):
            train.parse_args(["--arch", ARCH, "--smoke-config"])
        return
    with pytest.raises(tapi.SpecError, match="no enc_frames.*make_train_step"):
        tapi.TrainSession(spec, device="cpu")


def test_serving_refuses_the_enc_dec_family():
    """Refused until the enc-dec serving slice: ServeSession now serves
    whisper on the contiguous steps, and the paged steps refuse it,
    naming them (as ServeEngine does, as JAX's engine does)."""
    _, cfg = cfg_pair()
    assert tapi.ServeSession(tapi.RunSpec(arch=ARCH, smoke=True),
                             device="cpu").contiguous
    with pytest.raises(NotImplementedError, match="enc-dec family serves "
                       "on the contiguous steps"):
        tlm.batched_prefill_step(cfg, {}, torch.zeros((1, 4), dtype=torch.long),
                                 torch.ones(1))
    with pytest.raises(NotImplementedError, match="not ported to the paged"):
        ServeEngine(cfg, ServeConfig(), device="cpu")
