"""qk-norm (qwen3_32b, chameleon_34b) in the port on the CPU, held against
the JAX package on the same numpy-seeded inputs (weights carried across
with ``params_from_jax``), at their SMOKE widths in f32 (3 layers, d 64,
4 heads of 16, 2 KV heads).

What is held:

* the per-head norm (JAX's ``_qk_headnorm``, the port's ``rmsnorm`` over
  hd): bit for bit in bf16, the models' dtype; in f32 within 4 ulp
  (XLA sums the squares in another order and its ``rsqrt`` rounds
  otherwise: a probe at hd 128 found 142 of 296 row means and 95 of 296
  reciprocal roots an ulp apart);
* the trees (``q_norm`` and ``k_norm`` (hd,) a layer, replicated), their
  specs on sharded meshes, ``params_from_jax`` and ``init_params``;
* ``loss_fn`` and every gradient against JAX's jitted ``loss_fn``, also
  for whisper's SMOKE config with ``qk_norm`` set (the cross-attention
  norms its queries as JAX's does);
* one ``--sync optinc --bits 8`` step of 2 stacked peers against JAX's
  ``make_train_step`` on a 2-device data mesh, and the port's pre-sync
  gradient stack synced by JAX's ``_split_sync`` and by the port's
  ``sync_flat``, bit for bit;
* at mesh (1, 2) (a 2-rank gloo world against JAX's per-device values
  under ``check_vma=False``) every rank's loss and gradients; the
  replicated ``q_norm``/``k_norm`` gradients are each rank's partial
  over its own heads, and differ between the ranks;
* the serving steps (batched prefill, a paged decode step) and
  ServeSession's greedy tokens against JAX's.
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

from repro import api as japi
from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jconfigs
from repro.api import MeshSpec
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import ShardCtx as JCtx
from repro.serving import kv_pool as jkv
from test_torch_model import LENGTHS, NB, PS, _jax_paged_decode, _jax_prefill
from test_torch_processes import _env, _free_port, _wait
from repro_torch import api as tapi
from repro_torch.collectives.bucketizer import make_layout
from repro_torch.collectives.engine import SyncConfig, sync_flat
from repro_torch.configs import get
from repro_torch.launch import steps, train
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx, rmsnorm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving import kv_pool as tkv
from repro_torch.tree import leaves, leaves_with_paths, set_path, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3_32b", "chameleon_34b")
ARCH = "qwen3_32b"                  # the subprocess cases
SEED = 13
# the loss and each gradient leaf relative to its largest entry: f32
# matmuls and reductions in other orders (test_torch_sharding's limit)
GRAD_RTOL = 1e-5
# a trainer step: the losses, and the parameters where no optinc code
# flipped (test_torch_whisper's limit)
STEP_TOL = 1e-4
# logits O(1) after a prefill or a decode step (test_torch_model's limit)
LOGIT_TOL = 1e-4
PEERS, ROWS, SEQ = 2, 2, 37         # t 37: ragged against every tile
LR = 1e-3
SYNC_KW = dict(mode="optinc", bits=8, block=128, bucket_bytes=1 << 16)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)            # the gloo ranks' thread count
    yield
    torch.set_num_threads(old)


def cfg_pair(arch: str = ARCH):
    """(JAX config, port config) of the arch's SMOKE config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int, ctx: ShardCtx = ShardCtx()) -> dict:
    """numpy params at JAX's padded shapes: normal * 0.02, the norms 1 +
    0.1 normal (so a wrong norm weight or head shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg, ctx)):
        z = rng.standard_normal(shp).astype(np.float32)
        set_path(out, path, 1 + 0.1 * z if path[-1].endswith("norm")
                 else 0.02 * z)
    return out


def to_torch(tree) -> dict:
    return unflatten(tree, [torch.from_numpy(np.array(a))
                            for a in leaves(tree)])


def flat(tree: dict, prefix: str) -> dict:
    return {prefix + "/".join(p): a for p, a in leaves_with_paths(tree)}


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


def port_grads(cfg, params: dict, tokens: np.ndarray):
    """(loss, {path: gradient}) of the port's loss_fn, whole weights."""
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, unflatten(params, train_),
                          {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, train_)
    return loss.item(), {p: g.numpy() for (p, _), g in
                         zip(leaves_with_paths(params), grads)}


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
    out = {}

    def tree(prefix):
        t = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return t

    def put(mesh, specs, t):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), t, specs,
            is_leaf=lambda x: isinstance(x, P))

    def per_device(mesh, specs):
        return jax.tree.map(lambda _: P(tuple(mesh.axis_names)), specs,
                            is_leaf=lambda x: isinstance(x, P))

    def save(prefix, t):
        for path, a in jax.tree_util.tree_leaves_with_path(t):
            out[prefix + "/".join(p.key for p in path)] = np.asarray(a)

    # mesh (1, 2): each device's loss and gradients (check_vma=False)
    ms = MeshSpec(tp=2)
    mesh, ctx = ms.build(), ms.ctx()
    specs = lm.flat_specs(cfg, ctx)

    def f(p, t):
        (loss, _), g = jax.value_and_grad(
            lambda p: lm.loss_fn(cfg, ctx, p, {"tokens": t}),
            has_aux=True)(p)
        return loss[None], jax.tree.map(lambda x: x[None], g)
    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(specs, P(ctx.dp_axes, None)),
        out_specs=(P(tuple(mesh.axis_names)), per_device(mesh, specs)),
        check_vma=False))
    loss, grads = fn(put(mesh, specs, tree("tp/params/")),
                     jnp.asarray(inp["tp/tokens"]))
    out["tp/loss"] = np.asarray(loss)
    save("tp/grads/", grads)

    # a 2-device data mesh: one make_train_step, and _split_sync on the
    # port's per-peer gradients
    ms = MeshSpec(dp=2)
    mesh, ctx = ms.build(), ms.ctx()
    specs = lm.flat_specs(cfg, ctx)
    scfg = SyncConfig(axes=("data",), **spec["sync_kw"])
    opt = AdamWConfig(lr=spec["lr"])
    step = jax.jit(js.make_train_step(cfg, mesh, scfg, opt)[0])
    p = put(mesh, specs, tree("dp/params/"))
    ostate = put(mesh, js.opt_specs(specs), adamw_init(opt, p))
    sspec = js.sync_state_specs(mesh, scfg)
    sstate = put(mesh, sspec, js.init_sync_state(cfg, mesh, scfg))
    with jax.set_mesh(mesh):
        p, ostate, sstate, m = step(p, ostate, sstate,
                                    {"tokens": jnp.asarray(inp["dp/tokens"])},
                                    jax.random.PRNGKey(0))
    out["dp/loss"] = np.asarray(m["loss"])
    save("dp/params/", p)
    mask = js._fsdp_leaf_tree(specs, ctx)

    def sync_fn(g, st):
        g = jax.tree.map(lambda x: x[0], g)
        synced, new = js._split_sync(g, mask, ctx, scfg, None, st)
        return jax.tree.map(lambda x: x[None], synced), new
    dev = per_device(mesh, specs)
    fn = jax.jit(jax.shard_map(sync_fn, mesh=mesh, in_specs=(dev, sspec),
                               out_specs=(dev, sspec), check_vma=False))
    synced, _ = fn(tree("dp/grads/"), js.init_sync_state(cfg, mesh, scfg))
    save("dp/synced/", synced)
    np.savez(sys.argv[2], **out)
''')

# one rank of the (1, 2) gloo world: its shards' loss and gradients
RANK_MAIN = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.launch import distributed
    from repro_torch.models import lm
    from repro_torch.models.layers import ShardCtx
    from repro_torch.tree import leaves, leaves_with_paths, set_path, unflatten

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(spec["inputs"]))
    world = distributed.init(1, 1, 2, "cpu", datetime.timedelta(seconds=200))
    cfg = dataclasses.replace(get_smoke(spec["arch"]), dtype="float32")
    ctx = ShardCtx(tp=2)
    g = {}
    for k, v in inp.items():
        if k.startswith("tp/params/"):
            set_path(g, tuple(k[len("tp/params/"):].split("/")), v)
    params = lm.params_from_jax(g, cfg, "cpu", ctx, world.coords)
    train = [t.requires_grad_() for t in leaves(params)]
    loss, _ = lm.loss_fn(cfg, unflatten(params, train),
                         {"tokens": torch.from_numpy(inp["tp/tokens"])},
                         ctx, world)
    grads = torch.autograd.grad(loss, train)
    out = {"loss": loss.detach().numpy()}
    for (path, _), gr in zip(leaves_with_paths(params), grads):
        out["grads/" + "/".join(path)] = gr.numpy()
    np.savez(os.path.join(spec["out"], f"rank{world.rank}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (2 host devices: mesh (1, 2) per-device gradients,
    one dp-2 trainer step, the split sync of the port's step-0 gradient
    stack) and the port's (1, 2) gloo world, spawned together; the
    port's stacked dp-2 step runs here meanwhile."""
    d = tmp_path_factory.mktemp("qknorm")
    _, cfg = cfg_pair()
    rng = np.random.default_rng(SEED)
    inp = {**flat(np_params(cfg, SEED, ShardCtx(tp=2)), "tp/params/"),
           **flat(np_params(cfg, SEED + 1), "dp/params/"),
           "tp/tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ + 1)
                                     ).astype(np.int32),
           "dp/tokens": rng.integers(0, cfg.vocab, (PEERS * ROWS, SEQ + 1)
                                     ).astype(np.int32)}
    params = to_torch(tree_of(inp, "dp/params/"))
    tokens = torch.from_numpy(inp["dp/tokens"])
    layout = make_layout([(s, torch.float32) for s in
                          leaves(tlm.param_shapes(cfg))],
                         SYNC_KW["bucket_bytes"])
    _, stack = steps.peer_grad_stack(cfg, params, tokens, PEERS,
                                     layout.total)
    start = 0
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        n = int(np.prod(shp))
        inp["dp/grads/" + "/".join(path)] = stack[:, start:start + n].reshape(
            PEERS, *shp).numpy()
        start += n
    np.savez(d / "in.npz", **inp)
    spec = {"arch": ARCH, "sync_kw": SYNC_KW, "lr": LR}
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("OMP_NUM_THREADS")
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "jax_out.npz"), json.dumps(spec)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)]}
    port = _free_port()
    procs["gloo"] = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, json.dumps(
            {"arch": ARCH, "inputs": str(d / "in.npz"), "out": str(d)})],
        cwd=ROOT, env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                           LOCAL_WORLD_SIZE="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(2)]
    # the port's stacked dp-2 step, meanwhile
    sync, opt = SyncConfig(**SYNC_KW), AdamWConfig(lr=LR)
    ostate = adamw_init(opt, params)
    sstate = steps.init_sync_state(cfg, PEERS, sync, "cpu")
    step = steps.make_train_step(cfg, PEERS, sync, opt, "cpu")
    new, _, _, m = step(params, ostate, sstate, tokens)
    synced, _ = sync_flat(stack, layout.bounds, sync)
    res = _wait(procs, time.time() + SPAWN_TIMEOUT_S)
    for name, group in res.items():
        for rc, log in group:
            assert rc == 0, f"{name}: {log[-4000:]}"
    return dict(inp=inp, jax=dict(np.load(d / "jax_out.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(2)],
                loss=m["loss"].item(), params=new, synced=synced,
                layout=layout)


# ---------------------------------------------------------- the norm
@pytest.mark.parametrize("hd", [16, 80, 112, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qk_headnorm_is_jaxs(dtype, hd):
    """rmsnorm over hd against JAX's jitted ``_qk_headnorm`` at the
    SMOKE, qwen3 (80), zamba2 (112) and chameleon (128) head dims."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 37, 4, hd)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    want = np.asarray(jax.jit(jblocks._qk_headnorm)(jx, jw).astype(
        jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = rmsnorm(tx, tw).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=4)


# ---------------------------------------------------------- the trees
@pytest.mark.parametrize("arch", ARCHS)
def test_trees_and_specs_are_jaxs(arch):
    """At the published widths, 1 layer: 14 leaves (qwen3: 2,008,038,560
    parameters); the SMOKE tree's specs and shapes are JAX's on a
    sharded mesh, q_norm and k_norm (hd,) a layer and replicated."""
    import math
    full = tlm.param_shapes(dataclasses.replace(get(arch), n_layers=1))
    assert len(leaves(full)) == 14
    want = {"qwen3_32b": 2_008_038_560, "chameleon_34b": 1_765_826_816}
    assert sum(math.prod(s) for s in leaves(full)) == want[arch]
    jcfg, cfg = cfg_pair(arch)
    for tp, fsdp in ((1, False), (2, True)):
        jspecs, jshapes = jlm.param_specs(jcfg, JCtx(tp=tp, dp=2, fsdp=fsdp))
        specs, shapes = tlm.param_specs(cfg, ShardCtx(tp=tp, dp=2, fsdp=fsdp))
        assert shapes == jshapes
        jl = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
        assert [tuple(s) for s in leaves(specs)] == [tuple(s) for s in jl]
    assert shapes["layers"]["q_norm"] == (cfg.n_layers, cfg.hd)
    assert specs["layers"]["k_norm"] == (None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_and_init_follow_jax(arch):
    """JAX's bf16 init carried across bit for bit; the port's seeded
    init has JAX's shapes, its norms (q_norm, k_norm too) 1."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in cfg_pair(arch))
    jparams = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jsteps.make_ctx(MeshSpec().build()), jax.random.PRNGKey(1)))
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    for path, t in leaves_with_paths(params):
        want = jparams
        for k in path:
            want = want[k]
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    a = tlm.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == jax.tree.map(
        lambda t: tuple(t.shape), a)
    for k in ("q_norm", "k_norm"):
        assert torch.all(a["layers"][k] == 1)
        assert np.all(np.asarray(jparams["layers"][k]).astype(np.float32)
                      == 1)


# ------------------------------------------------ loss and gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """loss_fn and the gradient of every leaf (q_norm and k_norm
    included) against JAX's jitted loss_fn and value_and_grad."""
    jcfg, cfg = cfg_pair(arch)
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
    loss, grads = port_grads(cfg, to_torch(p), tokens)
    assert abs(loss - float(jloss)) <= GRAD_RTOL * abs(float(jloss))
    assert set(grads) >= {("layers", "q_norm"), ("layers", "k_norm")}
    for path, g in grads.items():
        want = np.asarray(jgrads[path[0]] if len(path) == 1
                          else jgrads[path[0]][path[1]])
        assert np.abs(want).max() > 0, path
        assert_rel(g, want, GRAD_RTOL, str(path))


def test_cross_attention_norms_its_queries_as_jax():
    """qk-norm in the encoder-decoder family (whisper_tiny's SMOKE config
    with ``qk_norm`` set; no shipped config has both): the decoder's
    cross-attention norms its queries with ``x_q_norm`` as JAX's does,
    so loss_fn and every gradient match JAX's (``x_k_norm`` is a leaf
    in both and unused in both: its gradient is 0)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("whisper_tiny"),
                               dtype="float32", qk_norm=True)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = np_params(cfg, SEED + 4)
    rng = np.random.default_rng(SEED + 5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, SEQ + 1)
                                    ).astype(np.int32),
             "enc_frames": rng.standard_normal(
                 (2, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
    mesh = MeshSpec().build()
    ctx = jsteps.make_ctx(mesh)
    specs = jlm.flat_specs(jcfg, ctx)

    def f(p, b):
        return jax.value_and_grad(lambda p: jlm.loss_fn(
            jcfg, ctx, p, b), has_aux=True)(p)
    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(specs, {"tokens": P(), "enc_frames": P()}),
        out_specs=((P(), {"nll": P()}), specs), check_vma=False))
    with jax.set_mesh(mesh):
        (jloss, _), jgrads = fn(jax.tree.map(jnp.asarray, p),
                                jax.tree.map(jnp.asarray, batch))
    params = to_torch(p)
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, unflatten(params, train_),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, train_, allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= GRAD_RTOL * abs(float(jloss))
    paths = [path for path, _ in leaves_with_paths(params)]
    assert ("decoder", "x_q_norm") in paths
    for path, g in zip(paths, grads):
        want = jgrads
        for k in path:
            want = want[k]
        want = np.asarray(want)
        got = np.zeros_like(want) if g is None else g.numpy()
        if path[-1] == "x_k_norm":
            assert not np.any(want) and not np.any(got), path
            continue
        assert np.abs(want).max() > 0, path
        assert_rel(got, want, GRAD_RTOL, str(path))


# ------------------------------------------------------------ trainers
def test_dp2_step_matches_jax_and_syncs_bit_for_bit(runs):
    """One --sync optinc --bits 8 step of 2 stacked peers against JAX's
    make_train_step on a 2-device data mesh (the loss, the parameters
    after it), and the port's step-0 gradient stack synced by JAX's
    _split_sync and by the port's sync_flat: bit for bit."""
    jout = runs["jax"]
    assert abs(runs["loss"] - float(jout["dp/loss"])) <= STEP_TOL
    for path, t in leaves_with_paths(runs["params"]):
        assert_rel(t.numpy(), jout["dp/params/" + "/".join(path)], STEP_TOL,
                   str(path))
    start = 0
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg_pair()[1])):
        n = int(np.prod(shp))
        want = jout["dp/synced/" + "/".join(path)]
        got = runs["synced"][start:start + n].reshape(shp).numpy()
        start += n
        for d in range(PEERS):
            assert np.array_equal(got, want[d]), (path, d)


def test_tp2_rank_gradients_match_jax_per_device(runs):
    """Mesh (1, 2): each gloo rank's loss and the gradients of its
    shards (and of its copy of the replicated leaves) against JAX's
    device values under check_vma=False."""
    jout = runs["jax"]
    for r, rank in enumerate(runs["ranks"]):
        np.testing.assert_allclose(rank["loss"], jout["tp/loss"][r],
                                   rtol=GRAD_RTOL, atol=0)
        keys = sorted(k for k in rank if k.startswith("grads/"))
        assert keys == sorted(k[3:] for k in jout
                              if k.startswith("tp/grads/"))
        for k in keys:
            want = jout["tp/" + k][r]
            assert rank[k].shape == want.shape, k
            assert_rel(rank[k], want, GRAD_RTOL, k)


def test_qk_norm_gradients_are_each_ranks_partial(runs):
    """q_norm and k_norm are replicated, but each 'model' rank normalises
    only its own heads, so each rank's gradient of them is its partial:
    the two ranks' differ, in JAX as in the port, and their sum is tp
    times the tp-1 gradient (JAX transposes the out-projection's psum
    into a psum under check_vma=False, so each rank's heads see tp times
    the cotangent).  Each rank keeps its own copy (ROADMAP: replicated
    leaves live per rank); nothing sums them."""
    _, cfg = cfg_pair()
    whole = tree_of(runs["inp"], "tp/params/")
    _, full = port_grads(cfg, to_torch(whole), runs["inp"]["tp/tokens"])
    for k in ("q_norm", "k_norm"):
        for src, per in (("port", [r[f"grads/layers/{k}"]
                                   for r in runs["ranks"]]),
                         ("jax", list(runs["jax"][f"tp/grads/layers/{k}"]))):
            scale = np.abs(per[0]).max()
            assert np.abs(per[0] - per[1]).max() > 1e-2 * scale, (src, k)
            assert_rel(per[0] + per[1], 2 * full[("layers", k)], GRAD_RTOL,
                       f"{src} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_smoke_config(arch, capsys):
    """The training CLI (RunSpec -> TrainSession) takes the qk-norm
    archs: stacked peers, finite losses that fall."""
    assert train.main(["--device", "cpu", "--arch", arch, "--smoke-config",
                       "--sync", "optinc", "--mesh", "2x1", "--steps", "6",
                       "--global-batch", "4", "--seq-len", "32", "--lr",
                       "3e-3"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(arch):
    """A packed, right-padded batched prefill and one paged decode step
    (JAX's gather backend) on the same weights: logits within LOGIT_TOL
    on the live rows, and the K the pool holds (normed and roped)."""
    jcfg, cfg = cfg_pair(arch)
    p = np_params(cfg, SEED + 4)
    jparams = jax.tree.map(jnp.asarray, p)
    params = to_torch(p)
    rng = np.random.default_rng(SEED + 5)
    b, t = len(LENGTHS), 16
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    jlog, jcache = _jax_prefill(jcfg, jparams, tokens, LENGTHS)
    with torch.inference_mode():
        tlog, tcache = tlm.batched_prefill_step(
            cfg, params, torch.from_numpy(tokens).long(),
            torch.from_numpy(LENGTHS))
    live = LENGTHS > 0
    np.testing.assert_allclose(tlog.numpy()[live], jlog[live],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tcache["layers"]["k"].numpy(),
                               jcache["layers"]["k"], atol=LOGIT_TOL, rtol=0)
    table = np.zeros((b, NB), np.int32)
    for i in range(b):
        table[i] = 1 + i * NB + np.arange(NB)
    table[~live] = 0
    jpool = jkv.write_prompts(
        jkv.init_pool(jcfg, JCtx(), 1 + b * NB, PS), jcache,
        jnp.asarray(table[:, :t // PS]), jnp.asarray(LENGTHS))
    tpool = tkv.write_prompts(tkv.init_pool(cfg, 1 + b * NB, PS, device="cpu"),
                              tcache, torch.from_numpy(table[:, :t // PS]),
                              torch.from_numpy(LENGTHS))
    token = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    jlog, jpool = _jax_paged_decode(jcfg, jparams, jpool, table, LENGTHS,
                                    token, "gather")
    with torch.inference_mode():
        tlog, tpool = tlm.paged_decode_step(
            cfg, params, tpool, torch.from_numpy(table),
            torch.from_numpy(LENGTHS), torch.from_numpy(token).long())
    np.testing.assert_allclose(tlog.numpy()[live], jlog[live],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tpool["layers"]["k"].numpy()[:, 1:],
                               jpool["layers"]["k"][:, 1:], atol=LOGIT_TOL,
                               rtol=0)


def test_serve_session_generate_matches_jax():
    """qwen3's SMOKE config served by ServeSession (prefill, the paged
    pool, bf16 K/V) against JAX's ServeSession (contiguous bf16 cache):
    the same greedy tokens."""
    jcfg, cfg = cfg_pair()
    p = np_params(cfg, SEED + 6)
    d = dict(arch=ARCH, smoke=True, steps=1,
             data=dict(vocab=0, seq_len=32, global_batch=2, seed=0),
             serve=dict(page_size=4, kv_dtype="bf16"), mesh=dict(dp=1))
    sess = tapi.ServeSession(tapi.RunSpec.from_json_dict(d),
                             params=to_torch(p), device="cpu", cfg=cfg)
    jsess = japi.ServeSession(japi.RunSpec.from_json_dict(d),
                              params=jax.tree.map(jnp.asarray, p))
    rng = np.random.default_rng(SEED + 7)
    for b, t in ((3, 7), (1, 1)):
        prompts = rng.integers(0, cfg.vocab, (b, t))
        want = np.asarray(jsess.generate(prompts, gen_len=6, max_seq=24))
        got = sess.generate(prompts, gen_len=6, max_seq=24)
        np.testing.assert_array_equal(got.numpy(), want)
