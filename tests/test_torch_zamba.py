"""The Mamba-2 hybrid (zamba2_7b) in the port on the CPU, held against the
JAX package on the same numpy-seeded inputs (weights carried across with
``params_from_jax``), at its SMOKE widths in f32 (7 layers, attn_every 3:
two groups of 2 mamba layers and the shared attention block, then a tail
of 1; d 64, d_inner 128 in 2 SSD heads of 64, ssm_state 16; the shared
block's 2 heads of 32).

What is held:

* ``ssd_chunk_scan`` (JAX's ``_ssd_chunk_scan``): y, the final state
  and the gradients at t < chunk and at a ragged t; at t 256 with chunk
  128 and zamba2's init (a -1, dt ~ 0.97) JAX's gradients are not
  finite (the reference's fault: its decay is ``where(mask, exp(rel),
  0)``, and exp(rel) overflows above the diagonal), while the port's are
  finite and equal, within SSD_RTOL, to JAX's own scan at chunk 32, the
  same function with no overflow;
* ``mamba2_block`` and the zamba2 SMOKE ``loss_fn`` and gradients (the
  shared block's summed over its two uses) at t 64;
* the tree (``mamba`` stacked, ``shared_attn`` not), its specs, shapes
  and inits (a_log 0, dt_bias 0.5, d_skip 1) against JAX's;
* one ``--sync optinc --bits 8`` step of 2 stacked peers against JAX's
  ``make_train_step`` on a 2-device data mesh, and a 2-rank gloo world
  of the same step against the stacked run, bit for bit; remat and the
  CLI;
* the refusals: tp > 1 and ``--fsdp`` (not ported yet), paged serving (JAX
  serves the family on its contiguous path only).
"""
import dataclasses
import json
import math
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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import ShardCtx as JCtx
from test_torch_processes import _env, _free_port, _wait
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
ARCH = "zamba2_7b"
SEED = 17
# the SSD's y, final state and gradients relative to each one's largest
# entry: the port computes the intra-chunk terms of all chunks at once
# and JAX in its scan, so their f32 sums run in other orders
SSD_RTOL = 1e-5
# the loss (O(5)) and each gradient leaf relative to its largest entry;
# a_log's gradient sums terms of both signs over every token (it read
# 1.2e-5 of its largest entry at t 64)
GRAD_RTOL = 1e-4
STEP_TOL = 1e-4                     # a trainer step (test_torch_whisper's)
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
    """(JAX config, port config) of zamba2's SMOKE config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int) -> dict:
    """numpy params at JAX's shapes: normal * 0.02 (the conv weights *
    0.5, JAX's scale for fan_in 4), norms 1, and a_log, dt_bias and
    d_skip spread around JAX's inits (0, 0.5, 1) so a swapped head
    shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        z = rng.standard_normal(shp).astype(np.float32)
        name = path[-1]
        base = {"a_log": 0.0, "dt_bias": 0.5, "d_skip": 1.0}.get(name)
        a = (1 + 0 * z if name.endswith("norm") else base + 0.1 * z
             if base is not None else 0.5 * z if name.startswith("conv")
             else 0.02 * z)
        set_path(out, path, a.astype(np.float32))
    return out


def to_torch(tree) -> dict:
    return unflatten(tree, [torch.from_numpy(np.array(a))
                            for a in leaves(tree)])


def tree_of(d: dict, prefix: str) -> dict:
    out = {}
    for k, v in d.items():
        if k.startswith(prefix):
            set_path(out, tuple(k[len(prefix):].split("/")), v)
    return out


def assert_rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def jax_tp1(fn):
    """fn in a shard_map over a 1-device mesh, jitted (the JAX blocks
    need the 'model' axis).  Returns (call, ctx)."""
    mesh = MeshSpec().build()
    sm = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                               check_vma=False))

    def call(*args):
        with jax.set_mesh(mesh):
            return sm(*args)
    return call, jsteps.make_ctx(mesh)


# --------------------------------------------------------- the SSD scan
def ssd_inputs(b, t, nh, hp, n, seed, dt_lo=0.01, dt_hi=0.2, a=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        xh=rng.standard_normal((b, t, nh, hp)).astype(f),
        dt=rng.uniform(dt_lo, dt_hi, (b, t, nh)).astype(f),
        a=(-np.exp(0.5 * rng.standard_normal(nh)) if a is None
           else np.full(nh, a)).astype(f),
        bmat=rng.standard_normal((b, t, n)).astype(f),
        cmat=rng.standard_normal((b, t, n)).astype(f),
        wy=rng.standard_normal((b, t, nh, hp)).astype(f),
        ws=rng.standard_normal((b, nh, hp, n)).astype(f))


NAMES = ("xh", "dt", "a", "bmat", "cmat")


def jax_ssd(ins: dict, chunk: int):
    """JAX's jitted scan: y, the final state and the gradients of sum(y
    wy) + sum(state ws) with respect to its five inputs."""
    def f(*args):
        y, s = jblocks._ssd_chunk_scan(*args, chunk)
        return jnp.sum(y * ins["wy"]) + jnp.sum(s * ins["ws"]), (y, s)
    (_, (y, s)), g = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(5)), has_aux=True))(
        *(jnp.asarray(ins[k]) for k in NAMES))
    return np.asarray(y), np.asarray(s), [np.asarray(x) for x in g]


def port_ssd(ins: dict, chunk: int):
    args = [torch.from_numpy(ins[k]).requires_grad_() for k in NAMES]
    y, s = blocks.ssd_chunk_scan(*args, chunk)
    g = torch.autograd.grad((y * torch.from_numpy(ins["wy"])).sum()
                            + (s * torch.from_numpy(ins["ws"])).sum(), args)
    return y.detach().numpy(), s.detach().numpy(), [x.numpy() for x in g]


@pytest.mark.parametrize("t,chunk", [(20, 32), (77, 32), (64, 16)],
                         ids=["t<chunk", "ragged", "whole_chunks"])
def test_ssd_chunk_scan_matches_jax(t, chunk):
    ins = ssd_inputs(2, t, 3, 8, 4, SEED + t)
    jy, js, jg = jax_ssd(ins, chunk)
    y, s, g = port_ssd(ins, chunk)
    assert y.shape == jy.shape == (2, t, 3, 8) and s.shape == (2, 3, 8, 4)
    assert_rel(y, jy, SSD_RTOL, "y")
    assert_rel(s, js, SSD_RTOL, "state")
    for name, a, b in zip(NAMES, g, jg):
        assert np.isfinite(b).all() and np.abs(b).max() > 0, name
        assert_rel(a, b, SSD_RTOL, name)


def test_long_chunks_repair_the_references_nan_gradient():
    """t 256, chunk 128, a -1 and dt ~ softplus(0.5) (zamba2's init):
    JAX's own scan has non-finite gradients at chunk 128 (pinned: the
    reference's fault) and finite ones at chunk 32; the port's at chunk
    128 are finite and equal JAX's at chunk 32 within SSD_RTOL, and its
    y is JAX's chunk-128 y."""
    ins = ssd_inputs(1, 256, 2, 8, 4, SEED, dt_lo=0.95, dt_hi=1.0, a=-1.0)
    jy, _, jg = jax_ssd(ins, 128)
    assert np.isfinite(jy).all()
    assert not all(np.isfinite(x).all() for x in jg)
    y32, s32, g32 = jax_ssd(ins, 32)
    assert all(np.isfinite(x).all() for x in g32)
    y, s, g = port_ssd(ins, 128)
    assert_rel(y, jy, SSD_RTOL, "y")
    assert_rel(y, y32, SSD_RTOL, "y chunk 32")
    assert_rel(s, s32, SSD_RTOL, "state")
    for name, a, b in zip(NAMES, g, g32):
        assert np.isfinite(a).all(), name
        assert_rel(a, b, SSD_RTOL, name)


def test_mamba2_block_matches_jax():
    """mamba2_block (layer 0 of the SMOKE stack) at t 64 with chunk 16
    (4 chunks): its output, the SSD's final state, and the gradients of
    sum(out w) with respect to x and every leaf, against JAX's at tp 1."""
    jcfg, cfg = cfg_pair()
    p = {k: v[0] for k, v in np_params(cfg, SEED)["mamba"].items()}
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)

    def jf(p, x):
        def f(p, x):
            out, st = jblocks.mamba2_block(ctx, jcfg, p, x, chunk=16)
            return jnp.sum(out * w), (out, st["ssm"])
        (_, (out, st)), g = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(p, x)
        return out, st, g
    call, ctx = jax_tp1(jf)
    jout, jst, (jgp, jgx) = call(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, st = blocks.mamba2_block(cfg, tp, tx, chunk=16)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *tp.values()])
    assert_rel(out.detach().numpy(), jout, SSD_RTOL, "out")
    assert_rel(st["ssm"].detach().numpy(), jst, SSD_RTOL, "state")
    assert_rel(grads[0].numpy(), jgx, GRAD_RTOL, "dx")
    for k, g in zip(tp, grads[1:]):
        assert np.abs(np.asarray(jgp[k])).max() > 0, k
        assert_rel(g.numpy(), jgp[k], GRAD_RTOL, k)


# ------------------------------------------------------------ the tree
@pytest.mark.parametrize("tp,fsdp", [(1, False), (2, False), (2, True)])
def test_tree_and_specs_are_jaxs(tp, fsdp):
    """At the published widths cut to 7 layers (6 mamba2 layers, one
    shared block): 23 leaves, 902,689,248 parameters; the SMOKE tree's
    specs, shapes and leaf order are JAX's on every mesh, the shared
    block's specs without the layer entry."""
    full = tlm.param_shapes(dataclasses.replace(get(ARCH), n_layers=7))
    assert len(leaves(full)) == 23
    assert sum(math.prod(s) for s in leaves(full)) == 902_689_248
    assert full["mamba"]["w_x"] == (6, 3584, 7168)
    assert full["mamba"]["a_log"] == (6, 112)
    assert full["shared_attn"]["wq"] == (3584, 32 * 112)
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
    assert len(specs["shared_attn"]["wq"]) == 2


def test_params_from_jax_and_init_follow_jax():
    """JAX's bf16 init carried across bit for bit (23 leaves); the
    port's seeded init has JAX's shapes and JAX's special values: norms
    1, a_log 0 (A = -1), dt_bias 0.5, d_skip 1, the conv weights drawn
    at 0.5 (fan_in 4), the rest at 0.02."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfg_pair())
    jparams = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jsteps.make_ctx(MeshSpec().build()), jax.random.PRNGKey(1)))
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    assert len(leaves(params)) == 23
    for path, t in leaves_with_paths(params):
        want = jparams
        for k in path:
            want = want[k]
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    a = tlm.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == jax.tree.map(
        lambda t: tuple(t.shape), a)
    for k, v in (("a_log", 0.0), ("dt_bias", 0.5), ("d_skip", 1.0),
                 ("norm", 1.0)):
        assert torch.all(a["mamba"][k] == v), k
        assert np.all(jparams["mamba"][k].astype(np.float32) == v), k
    assert torch.all(a["shared_attn"]["mlp_norm"] == 1)
    assert abs(a["mamba"]["conv_x"].float().std().item() - 0.5) < 0.05
    assert abs(a["mamba"]["w_x"].float().std().item() - 0.02) < 2e-3


# ------------------------------------------------ loss and gradients
def _port_loss_and_grads(cfg, p, tokens, ctx=ShardCtx()):
    params = to_torch(p)
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, unflatten(params, train_),
                          {"tokens": torch.from_numpy(tokens)}, ctx)
    return loss, torch.autograd.grad(loss, train_), params


def test_loss_and_gradients_match_jax():
    """loss_fn of the grouped forward (two groups of 2 mamba layers,
    each followed by the shared block, then the tail layer) and every
    leaf's gradient against JAX's jitted loss_fn, t 64."""
    jcfg, cfg = cfg_pair()
    p = np_params(cfg, SEED + 2)
    tokens = np.random.default_rng(SEED + 3).integers(
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
    """Checkpointing every mamba layer and every group (remat_groups >
    0, JAX's ``ckpt``) changes no number: the loss and every gradient
    bit for bit."""
    _, cfg = cfg_pair()
    p = np_params(cfg, SEED + 4)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab, (2, 33)).astype(np.int32)
    loss, grads, _ = _port_loss_and_grads(cfg, p, tokens)
    rloss, rgrads, _ = _port_loss_and_grads(cfg, p, tokens,
                                            ShardCtx(remat_groups=groups))
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))


# ------------------------------------------------------------ trainers
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
    out = {}
    with jax.set_mesh(mesh):
        p, ostate, sstate, m = step(p, ostate, sstate,
                                    {"tokens": jnp.asarray(inp["tokens"])},
                                    jax.random.PRNGKey(0))
    out["loss"] = np.asarray(m["loss"])
    for path, a in jax.tree_util.tree_leaves_with_path(p):
        out["params/" + "/".join(q.key for q in path)] = np.asarray(a)
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
    from repro_torch.tree import leaves_with_paths, set_path

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
    for i in range(2):
        params, ostate, sstate, m = step(params, ostate, sstate,
                                         torch.from_numpy(inp["tokens"]))
        out[f"loss{i}"] = m["loss"].numpy()
    for path, t in leaves_with_paths(params):
        out["params/" + "/".join(path)] = t.numpy()
    np.savez(os.path.join(spec["out"], f"rank{world.rank}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dp-2 trainer (one subprocess, 2 host devices) and the port's
    2-rank gloo world of the same step, spawned together."""
    d = tmp_path_factory.mktemp("zamba")
    _, cfg = cfg_pair()
    inp = {"params/" + "/".join(path): a for path, a in
           leaves_with_paths(np_params(cfg, SEED + 6))}
    inp["tokens"] = np.random.default_rng(SEED + 7).integers(
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
    """The training CLI (RunSpec -> TrainSession) takes zamba2: stacked
    peers, finite losses that fall."""
    assert train.main(["--device", "cpu", "--arch", ARCH, "--smoke-config",
                       "--sync", "optinc", "--mesh", "2x1", "--steps", "6",
                       "--global-batch", "4", "--seq-len", "32", "--lr",
                       "3e-3"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


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


def test_serving_refuses_the_ssm_family():
    """JAX serves zamba2 on its contiguous ServeSession path only, and so
    does the port (tests/test_torch_serve_families.py holds it against
    JAX); the port's paged serving refuses it by name."""
    _, cfg = cfg_pair()
    sess = tapi.ServeSession(tapi.RunSpec(arch=ARCH, smoke=True),
                             device="cpu", cfg=cfg)
    assert sess.contiguous and sess.generate([[1, 2, 3]], 2).shape == (1, 2)
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(cfg, ServeConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="ssm family"):
        tlm.batched_prefill_step(cfg, {}, torch.zeros((1, 4),
                                                      dtype=torch.long),
                                 torch.ones(1))
