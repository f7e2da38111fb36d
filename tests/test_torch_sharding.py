"""FSDP, tensor parallelism and remat groups of the port, on the CPU,
held against the JAX package's shard_map programs on the same inputs.

The smoke configs of llama3_405b (8 heads, 2 KV heads, so tp 4
replicates the KV heads) and deepseek_coder_33b run in f32.  The
parameters are made here with numpy from a seed at JAX's padded global
shapes, and go to both sides.  The JAX reference runs on 4 host devices
in one subprocess (``JAX_SCRIPT``, compiled as it runs); its per-device
values are the leading dimension of shard_map outputs with
``P(all axes)``, in JAX's device order.  The port runs as gloo worlds,
one a mesh shape, spawned once for the module with the launcher of
``test_torch_processes`` (each spawn its own time limit, torch pinned
to one thread); a world runs all the cases of its shape in one process
group.

What is held:

* per rank, the loss and the local gradients against JAX's per-device
  ones at meshes (data, model) (1, 2), (1, 4), (2, 1) + fsdp and (2, 2)
  + fsdp, within GRAD_RTOL of each leaf's largest entry;
* the reference's ``check_vma=False`` gradients, pinned: model-sharded
  leaves get tp times the tp-1 gradient, and the replicated leaves'
  gradients differ between model ranks;
* JAX's ``_split_sync`` on identical per-device gradients, bit for bit
  (synced leaves and residuals): optinc bits 8 with error feedback and
  FSDP, psum (within PSUM_ULPS) and the ring with tp 2, and the cascade
  over 2 pods with FSDP, whose FSDP group degrades to optinc;
* two whole train steps of each of those against JAX's
  ``make_train_step`` (TrainSession on the port's side): losses and
  every rank's parameters within the trainer tolerance;
* the stacked ``--fsdp`` session equal to the 2 x 2 processes bit for
  bit, ``params_from_jax``/``assemble_leaf`` round trips, a sharded
  checkpoint of the port read by JAX's loader and JAX's resumed by the
  port, and ``--remat-groups`` equal to no remat.
"""
import dataclasses
import json
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_processes import _env, _free_port, _wait
from repro_torch import api as tapi
from repro_torch.configs import get_smoke
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ShardCtx
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 300
SEED = 11
BATCH, SEQ = 4, 32
# the loss and each gradient leaf relative to its largest entry: f32
# matmuls and reductions summed in other orders by XLA and PyTorch
GRAD_RTOL = 1e-5
# two trainer steps (test_torch_train's tolerance): losses within it,
# parameters within it where no optinc code flipped (a gradient within
# an ulp of a rounding edge moves its weight by one AdamW step, lr)
TRAIN_TOL = 2e-4
LR = 1e-3
# psum over gloo vs XLA's f32 sum of 2 values and the division by 2
PSUM_ULPS = 3

# (arch, pods, dp, tp, fsdp)
GRAD_CASES = {
    "tp2": ("llama3_405b", 1, 1, 2, False),
    "tp4": ("llama3_405b", 1, 1, 4, False),
    "fsdp2": ("llama3_405b", 1, 2, 1, True),
    "fsdp2x2": ("deepseek_coder_33b", 1, 2, 2, True),
}
# (pods, dp, tp, fsdp, sync) on llama3_405b SMOKE
TRAIN_CASES = {
    "optinc8_ef_fsdp": (1, 2, 2, True,
                        dict(mode="optinc", bits=8, error_feedback=True)),
    "psum_tp": (1, 2, 2, False, dict(mode="psum")),
    "ring_tp": (1, 2, 2, False, dict(mode="ring")),
    "cascade_fsdp": (2, 2, 1, True,
                     dict(mode="cascade", bits=8, error_feedback=True)),
}
SYNC_KW = dict(block=128, bucket_bytes=1 << 16)
CKPT_CASE = "optinc8_ef_fsdp"        # both checkpoint directions
TRAIN_STEPS = 2


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' thread count
    yield
    torch.set_num_threads(old)


def f32_cfg(arch: str):
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def ctx_of(pods, dp, tp, fsdp) -> ShardCtx:
    return ShardCtx(tp=tp, dp=dp, pods=pods, fsdp=fsdp)


def make_params(arch: str, ctx: ShardCtx, seed: int) -> dict:
    """numpy global params at JAX's padded shapes for ``ctx``: normal *
    0.02, norms 1, flat as "path/to/leaf" keys."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(f32_cfg(arch), ctx)):
        if path[-1].endswith("norm"):
            a = np.ones(shp, np.float32)
        else:
            a = (rng.standard_normal(shp) * 0.02).astype(np.float32)
        out["/".join(path)] = a
    return out


def tree_of(flat: dict, prefix: str = "") -> dict:
    """{"a/b": x} (keys under ``prefix``) -> {"a": {"b": x}}."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def run_spec(name: str, ckpt=None, resume=False) -> tapi.RunSpec:
    pods, dp, tp, fsdp, sync = TRAIN_CASES[name]
    d = dict(arch="llama3_405b", smoke=True, steps=TRAIN_STEPS,
             optim=dict(lr=LR),
             data=dict(vocab=0, seq_len=SEQ, global_batch=BATCH, seed=SEED),
             sync={**sync, **SYNC_KW},
             mesh=dict(pods=pods, dp=dp, tp=tp, fsdp=fsdp))
    if ckpt is not None:
        d["ckpt"] = dict(dir=str(ckpt), every=TRAIN_STEPS, resume=resume)
    return tapi.RunSpec.from_json_dict(d)


def grad_inputs(name: str, ctx: ShardCtx) -> dict:
    """Per-device gradient trees for the split-sync check: numpy normals
    of each leaf's local shape, (ndev, *local), flat keys."""
    rng = np.random.default_rng(hash(name) % 2 ** 31)
    ndev = ctx.pods * ctx.dp * ctx.tp
    local = tlm.local_param_shapes(f32_cfg("llama3_405b"), ctx)
    return {"/".join(p): (rng.standard_normal((ndev, *s)) * 1e-3).astype(
        np.float32) for p, s in leaves_with_paths(local)}


# ------------------------------------------------------ the JAX side
JAX_SCRIPT = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat  # noqa: F401
    from repro import configs
    from repro.api import MeshSpec
    from repro.checkpoint import save_checkpoint
    from repro.collectives import SyncConfig
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import steps as js
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init

    inp = dict(np.load(sys.argv[1]))
    spec = json.loads(sys.argv[3])
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

    def setup(arch, pods, dp, tp, fsdp):
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        ms = MeshSpec(dp=dp, tp=tp, pods=pods, fsdp=fsdp)
        mesh = ms.build()
        return cfg, mesh, ms.ctx()

    def per_device(mesh, tree_):
        """Leading device axis of every leaf -> P(all axes)."""
        return jax.tree.map(lambda _: P(tuple(mesh.axis_names)), tree_,
                            is_leaf=lambda x: isinstance(x, P))

    def put(mesh, specs, t):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), t, specs,
            is_leaf=lambda x: isinstance(x, P))

    def shards(mesh, a):
        """(ndev, *local): each device's buffer in mesh order."""
        pos = {d.id: i for i, d in enumerate(mesh.devices.flat)}
        got = sorted(a.addressable_shards, key=lambda s: pos[s.device.id])
        return np.stack([np.asarray(s.data) for s in got])

    def save(prefix, t):
        for path, a in jax.tree_util.tree_leaves_with_path(t):
            key = "/".join(p.key for p in path)
            out[prefix + key] = np.asarray(a)

    for name, (arch, pods, dp, tp, fsdp) in spec["grads"].items():
        cfg, mesh, ctx = setup(arch, pods, dp, tp, fsdp)
        specs = lm.flat_specs(cfg, ctx)
        params = put(mesh, specs, tree(f"g/{name}/params/"))
        tokens = jnp.asarray(inp[f"g/{name}/tokens"])

        def f(p, t):
            (loss, _), g = jax.value_and_grad(
                lambda p: lm.loss_fn(cfg, ctx, p, {"tokens": t}),
                has_aux=True)(p)
            return loss[None], jax.tree.map(lambda x: x[None], g)
        fn = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(specs, P(ctx.dp_axes, None)),
            out_specs=(P(tuple(mesh.axis_names)), per_device(mesh, specs)),
            check_vma=False))
        loss, grads = fn(params, tokens)
        out[f"g/{name}/loss"] = np.asarray(loss)
        save(f"g/{name}/grads/", grads)

    opt = AdamWConfig(lr=spec["lr"])
    for name, (pods, dp, tp, fsdp, sync) in spec["train"].items():
        cfg, mesh, ctx = setup("llama3_405b", pods, dp, tp, fsdp)
        axes = ("pod", "data") if pods > 1 else ("data",)
        scfg = SyncConfig(axes=axes, **sync, **spec["sync_kw"])
        specs = lm.flat_specs(cfg, ctx)
        fsdp_mask = js._fsdp_leaf_tree(specs, ctx)
        # the split sync on identical per-device gradients
        g_in = tree(f"s/{name}/grads/")
        ss = js.init_sync_state(cfg, mesh, scfg, fsdp=fsdp)

        def sync_fn(g, st):
            g = jax.tree.map(lambda x: x[0], g)
            synced, new = js._split_sync(g, fsdp_mask, ctx, scfg, None, st)
            return jax.tree.map(lambda x: x[None], synced), new
        dev = per_device(mesh, specs)
        sspec = js.sync_state_specs(mesh, scfg)
        fn = jax.jit(jax.shard_map(
            sync_fn, mesh=mesh, in_specs=(dev, sspec),
            out_specs=(dev, sspec), check_vma=False))
        synced, new = fn(g_in, ss)
        save(f"s/{name}/synced/", synced)
        for k, v in new.items():
            out[f"s/{name}/residual/{k}"] = np.asarray(v)
        # two whole train steps
        step_fn, in_specs, _ = js.make_train_step(cfg, mesh, scfg, opt,
                                                  fsdp=fsdp)
        step = jax.jit(step_fn)
        params = put(mesh, specs, tree(f"t/{name}/params/"))
        opt_state = put(mesh, js.opt_specs(specs), adamw_init(opt, params))
        sync_state = put(mesh, sspec, js.init_sync_state(cfg, mesh, scfg,
                                                         fsdp=fsdp))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                      global_batch=spec["batch"],
                                      seed=spec["seed"]))
        for i in range(spec["steps"]):
            batch = {"tokens": jnp.asarray(data.batch(i))}
            params, opt_state, sync_state, metrics = step(
                params, opt_state, sync_state, batch,
                jax.random.PRNGKey(i))
            out[f"t/{name}/loss{i}"] = np.asarray(metrics["loss"])
            for path, a in jax.tree_util.tree_leaves_with_path(params):
                key = "/".join(p.key for p in path)
                out[f"t/{name}/{i}/params/{key}"] = shards(mesh, a)
            for k, v in sync_state.items():
                out[f"t/{name}/{i}/residual/{k}"] = np.asarray(v)
        if name == spec["ckpt_case"]:
            save_checkpoint(spec["ckpt_dir"], spec["steps"] - 1, params,
                            opt_state, sync_state=sync_state,
                            extra={"run_spec": spec["run_spec"]})
            for path, a in jax.tree_util.tree_leaves_with_path(
                    {"params": params, "m": opt_state["m"],
                     "v": opt_state["v"]}):
                key = "/".join(p.key for p in path)
                out[f"c/{key}"] = shards(mesh, a)
    np.savez(sys.argv[2], **out)
''')


# ----------------------------------------------------- the port's side
RANK_MAIN = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch import api
    from repro_torch.configs import get_smoke
    from repro_torch.launch import distributed, steps
    from repro_torch.models import lm
    from repro_torch.models.layers import ShardCtx
    from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(spec["inputs"]))
    pods, dp, tp = spec["mesh"]
    world = distributed.init(pods, dp, tp, "cpu",
                             datetime.timedelta(seconds=240))
    r = world.rank
    out = {}

    def tree(prefix):
        t = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return t

    def f32(arch):
        return dataclasses.replace(get_smoke(arch), dtype="float32")

    def save(prefix, t):
        for path, a in leaves_with_paths(t):
            out[prefix + "/".join(path)] = a.detach().numpy()

    for name, (arch, fsdp) in spec["grads"].items():
        cfg = f32(arch)
        ctx = ShardCtx(tp=tp, dp=dp, pods=pods, fsdp=fsdp)
        params = lm.params_from_jax(tree(f"g/{name}/params/"), cfg, "cpu",
                                    ctx, world.coords)
        tokens = torch.from_numpy(inp[f"g/{name}/tokens"])
        pod, d, _ = world.coords
        per = tokens.shape[0] // (pods * dp)
        p = pod * dp + d
        train = [t.requires_grad_() for t in leaves(params)]
        loss, _ = lm.loss_fn(cfg, unflatten(params, train),
                             {"tokens": tokens[p * per:(p + 1) * per]},
                             ctx, world)
        grads = torch.autograd.grad(loss, train)
        out[f"g/{name}/loss"] = loss.detach().numpy()
        save(f"g/{name}/grads/", unflatten(params, grads))

    for name, run in spec["train"].items():
        s = api.RunSpec.from_json_dict(run["spec"])
        cfg = f32("llama3_405b")
        g = tree(f"t/{name}/params/")
        params = unflatten(lm.param_shapes(cfg, s.mesh.ctx()), [
            torch.from_numpy(a) for a in leaves(g)])
        sess = api.TrainSession(s, callbacks=[
            api.PeriodicCheckpoint(s.ckpt.every)], device="cpu",
            params=params, cfg=cfg)
        # the split sync on the identical gradients of the JAX side
        gin = [torch.from_numpy(a[r]) for a in leaves(tree(
            f"s/{name}/grads/"))]
        synced, new = sess._step_fn.sync_grads(gin, sess.sync_state)
        save(f"s/{name}/synced/", unflatten(sess.params, synced))
        for k, v in new.items():
            out[f"s/{name}/residual/{k}"] = v.numpy()
        sess.run()
        out[f"t/{name}/losses"] = np.array(
            [sess.losses[i] for i in range(s.steps)])
        save(f"t/{name}/params/", sess.params)
        for k, v in sess.sync_state.items():
            out[f"t/{name}/residual/{k}"] = v.numpy()
        sent = world.axis_bytes["world/gather:float32"]
        g = steps.to_global(sess.params, cfg, sess.ctx, world)
        out[f"t/{name}/global_devices"] = np.array(
            [] if g is None else sorted({str(t.device) for t in leaves(g)}))
        out[f"t/{name}/global_sent"] = np.array(
            world.axis_bytes["world/gather:float32"] - sent)
    if spec.get("resume"):
        s = api.RunSpec.from_json_dict(spec["resume"])
        sess = api.TrainSession(s, callbacks=[], device="cpu",
                                cfg=f32("llama3_405b"))
        out["resume/step"] = np.array(sess.step)
        save("resume/params/", sess.params)
        save("resume/m/", sess.opt_state["m"])
        save("resume/v/", sess.opt_state["v"])
        for k, v in sess.sync_state.items():
            out[f"resume/residual/{k}"] = v.numpy()
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


def _spawn(spec: dict, n: int) -> list:
    import subprocess
    port = _free_port()
    procs = []
    for r in range(n):
        env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, json.dumps(spec)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    return procs


def _ranks(res, out: Path, n: int) -> list:
    for rc, log in res:
        assert rc == 0, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference and the port's worlds, spawned together, then
    the port's resume of JAX's checkpoint."""
    import subprocess
    d = tmp_path_factory.mktemp("sharding")
    inp = {}
    for name, (arch, pods, dp, tp, fsdp) in GRAD_CASES.items():
        ctx = ctx_of(pods, dp, tp, fsdp)
        inp.update({f"g/{name}/params/{k}": v for k, v in
                    make_params(arch, ctx, SEED).items()})
        inp[f"g/{name}/tokens"] = np.random.default_rng(SEED).integers(
            0, f32_cfg(arch).vocab, (BATCH, SEQ + 1)).astype(np.int32)
    for name, (pods, dp, tp, fsdp, _) in TRAIN_CASES.items():
        ctx = ctx_of(pods, dp, tp, fsdp)
        inp.update({f"t/{name}/params/{k}": v for k, v in
                    make_params("llama3_405b", ctx, SEED + 1).items()})
        inp.update({f"s/{name}/grads/{k}": v for k, v in
                    grad_inputs(name, ctx).items()})
    np.savez(d / "in.npz", **inp)
    jax_ckpt = d / "jax_ckpt"
    jspec = {"grads": GRAD_CASES, "train": TRAIN_CASES, "sync_kw": SYNC_KW,
             "lr": LR, "seq": SEQ, "batch": BATCH, "seed": SEED,
             "steps": TRAIN_STEPS, "ckpt_case": CKPT_CASE,
             "ckpt_dir": str(jax_ckpt),
             "run_spec": run_spec(CKPT_CASE).to_json_dict()}
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("OMP_NUM_THREADS")
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "jax_out.npz"), json.dumps(jspec)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)]}
    worlds = {}
    for name, (arch, pods, dp, tp, fsdp) in GRAD_CASES.items():
        worlds.setdefault((pods, dp, tp), {"grads": {}, "train": {}})[
            "grads"][name] = (arch, fsdp)
    for name, (pods, dp, tp, fsdp, _) in TRAIN_CASES.items():
        ck = d / f"port_ckpt_{name}" if name == CKPT_CASE else None
        worlds.setdefault((pods, dp, tp), {"grads": {}, "train": {}})[
            "train"][name] = {"spec": run_spec(name, ck).to_json_dict()}
    t0 = time.time()
    for mesh, cases in worlds.items():
        out = d / "w{}x{}x{}".format(*mesh)
        out.mkdir()
        procs[mesh] = _spawn({"inputs": str(d / "in.npz"), "out": str(out),
                              "mesh": mesh, **cases}, int(np.prod(mesh)))
    res = _wait(procs, t0 + SPAWN_TIMEOUT_S)
    (rc, log), = res.pop("jax")
    assert rc == 0, log[-4000:]
    ranks = {m: _ranks(r, d / "w{}x{}x{}".format(*m), int(np.prod(m)))
             for m, r in res.items()}
    # the port resumes JAX's checkpoint on the mesh that wrote it
    pods, dp, tp = TRAIN_CASES[CKPT_CASE][:3]
    out = d / "resume"
    out.mkdir()
    res = _wait({"r": _spawn({
        "inputs": str(d / "in.npz"), "out": str(out), "mesh": (pods, dp, tp),
        "grads": {}, "train": {}, "resume": run_spec(
            CKPT_CASE, jax_ckpt, resume=True).to_json_dict()},
        pods * dp * tp)}, time.time() + SPAWN_TIMEOUT_S)
    resume = _ranks(res["r"], out, pods * dp * tp)
    return dict(dir=d, inp=inp, jax=dict(np.load(d / "jax_out.npz")),
                ranks=ranks, resume=resume)


def _leaf_keys(prefix: str, rank: dict) -> list:
    return sorted(k[len(prefix):] for k in rank if k.startswith(prefix))


# ------------------------------------------------ shapes and shards
@pytest.mark.parametrize("arch,pods,dp,tp,fsdp", [
    ("llama3_405b", 1, 1, 1, False), ("llama3_405b", 1, 1, 2, False),
    ("llama3_405b", 1, 1, 4, False), ("llama3_405b", 1, 2, 2, True),
    ("deepseek_coder_33b", 2, 2, 1, True), ("deepseek_coder_33b", 1, 1, 4,
                                            True)])
def test_specs_and_shapes_are_jaxs(arch, pods, dp, tp, fsdp):
    """The port's param specs, padded global shapes and local shapes are
    JAX's ``param_specs`` and its shard_map local shapes (KV heads
    replicated when kv < tp, vocabulary and heads padded)."""
    from jax.sharding import PartitionSpec as P
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.models.layers import ShardCtx as JCtx
    import jax
    cfg = f32_cfg(arch)
    jctx = JCtx(tp=tp, dp=dp, pods=pods, fsdp=fsdp)
    jspecs, jshapes = jlm.param_specs(jconfigs.get_smoke(arch), jctx)
    specs, shapes = tlm.param_specs(cfg, ctx_of(pods, dp, tp, fsdp))
    assert shapes == jshapes
    want = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    assert [tuple(s) for s in leaves(specs)] == [tuple(s) for s in want]
    sizes, masks = tsteps._local_leaf_sizes(cfg, ctx_of(pods, dp, tp, fsdp))

    class Mesh:
        axis_names = ("pod", "data", "model")
        devices = np.empty((pods, dp, tp))
    jsizes, jmasks = jsteps._local_leaf_sizes(jconfigs.get_smoke(arch), jctx,
                                              Mesh)
    assert (sizes, masks) == (jsizes, jmasks)


@pytest.mark.parametrize("pods,dp,tp,fsdp", [(1, 1, 4, False),
                                             (1, 2, 2, True),
                                             (2, 2, 1, True)])
def test_params_from_jax_round_trips_bit_for_bit(pods, dp, tp, fsdp):
    """Every rank's ``params_from_jax`` shards, joined by
    ``assemble_leaf`` in rank order, are the global arrays bit for bit;
    the stacked ``to_local``/``to_global`` pair too."""
    cfg = f32_cfg("llama3_405b")
    ctx = ctx_of(pods, dp, tp, fsdp)
    g = tree_of(make_params("llama3_405b", ctx, 3))
    ranks = [tlm.params_from_jax(g, cfg, "cpu", ctx,
                                 (r // (dp * tp), r // tp % dp, r % tp))
             for r in range(pods * dp * tp)]
    for i, (sp, want) in enumerate(zip(tlm.spec_leaves(cfg, ctx),
                                       leaves(g))):
        got = tlm.assemble_leaf(torch.stack([leaves(p)[i] for p in ranks]),
                                sp, ctx)
        assert np.array_equal(got.numpy(), want)
    if tp == 1:
        whole = tlm.params_from_jax(g, cfg, "cpu", ctx)
        back = tsteps.to_global(tsteps.to_local(whole, cfg, ctx), cfg, ctx)
        assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(whole)))


# --------------------------------------------- losses and gradients
def _grad_close(got, want, rtol=GRAD_RTOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_and_local_gradients_match_jax_per_device(runs, name):
    arch, pods, dp, tp, fsdp = GRAD_CASES[name]
    ranks = runs["ranks"][(pods, dp, tp)]
    jax = runs["jax"]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[f"g/{name}/loss"],
                                   jax[f"g/{name}/loss"][r],
                                   rtol=GRAD_RTOL, atol=0)
        keys = _leaf_keys(f"g/{name}/grads/", rank)
        assert keys and keys == _leaf_keys(f"g/{name}/grads/", jax)
        for k in keys:
            got = rank[f"g/{name}/grads/{k}"]
            want = jax[f"g/{name}/grads/{k}"][r]
            assert got.shape == want.shape, k
            _grad_close(got, want)


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_tp_gradients_are_the_references_check_vma_false_ones(runs, name):
    """JAX transposes psum into psum under ``check_vma=False``: every
    model-sharded leaf's local gradient is tp times the tp-1 gradient's
    shard, and the replicated norms' gradients differ between the model
    ranks (each rank updates its own copy); JAX's show the same."""
    arch, pods, dp, tp, fsdp = GRAD_CASES[name]
    cfg = f32_cfg(arch)
    ctx = ctx_of(pods, dp, tp, fsdp)
    g = {k[len(f"g/{name}/params/"):]: v for k, v in runs["inp"].items()
         if k.startswith(f"g/{name}/params/")}
    one = tlm.param_shapes(cfg)
    same = {"/".join(p) for p, s in leaves_with_paths(one)
            if g["/".join(p)].shape == s}
    params = [torch.from_numpy(g[k]).requires_grad_() for k in sorted(g)]
    tokens = torch.from_numpy(runs["inp"][f"g/{name}/tokens"])
    loss, _ = tlm.loss_fn(cfg, unflatten(tree_of(g), params),
                          {"tokens": tokens})
    full = dict(zip(sorted(g), torch.autograd.grad(loss, params)))
    specs = dict(zip(sorted(g), tlm.spec_leaves(cfg, ctx)))
    ranks = runs["ranks"][(pods, dp, tp)]
    checked = 0
    for k in sorted(g):
        local = [rk[f"g/{name}/grads/{k}"] for rk in ranks]
        if "model" in specs[k]:
            if k not in same:
                continue            # the padded KV heads of tp 4
            for r, got in enumerate(local):
                want = tlm.shard_leaf(full[k], specs[k], ctx, (0, 0, r))
                _grad_close(got, tp * want.numpy())
                _grad_close(runs["jax"][f"g/{name}/grads/{k}"][r],
                            tp * want.numpy())
                checked += 1
        else:
            spread = max(float(np.abs(x - local[0]).max()) for x in local)
            jl = runs["jax"][f"g/{name}/grads/{k}"]
            jspread = float(np.abs(jl - jl[0]).max())
            assert spread > 1e-3 * float(np.abs(local[0]).max()), k
            assert jspread > 1e-3 * float(np.abs(jl[0]).max()), k
    assert checked >= 5 * tp


# ------------------------------------------------------- the sync
@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_split_sync_is_bit_equal_to_jaxs(runs, name):
    """JAX's ``_split_sync`` and the port's on the same per-device
    gradients: every rank's synced leaves and residual rows are JAX's
    device values bit for bit (psum within PSUM_ULPS: gloo and XLA sum
    in their own orders)."""
    pods, dp, tp, fsdp, sync = TRAIN_CASES[name]
    ranks = runs["ranks"][(pods, dp, tp)]
    jax = runs["jax"]
    keys = _leaf_keys(f"s/{name}/synced/", ranks[0])
    assert keys == _leaf_keys(f"s/{name}/synced/", jax)
    for r, rank in enumerate(ranks):
        for k in keys:
            got = rank[f"s/{name}/synced/{k}"]
            want = jax[f"s/{name}/synced/{k}"][r]
            if sync["mode"] == "psum":
                x = runs["inp"][f"s/{name}/grads/{k}"]
                tol = PSUM_ULPS * np.spacing(np.abs(x).sum(0).max() / dp)
                assert np.abs(got - want).max() <= tol, k
            else:
                assert np.array_equal(got, want), (r, k)
        for k in ("rep", "fsdp"):
            jk = f"s/{name}/residual/{k}"
            if not sync.get("error_feedback"):
                assert jk not in rank and jk not in jax
            elif not jax[jk].size:
                assert jk not in rank
            else:
                got = rank[jk][0]
                n = got.size
                assert np.array_equal(got, jax[jk][r * n:(r + 1) * n]), k


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_steps_match_jaxs_make_train_step(runs, name):
    """Two whole steps through TrainSession on every rank against JAX's
    jitted ``make_train_step`` from the same weights and batches: the
    losses within TRAIN_TOL, and each rank's parameters (its shards, its
    own copy of the replicated leaves) within TRAIN_TOL but where an
    optinc code flipped, which moves a weight by at most one AdamW step
    a step."""
    pods, dp, tp, fsdp, sync = TRAIN_CASES[name]
    ranks = runs["ranks"][(pods, dp, tp)]
    jax = runs["jax"]
    want = [float(jax[f"t/{name}/loss{i}"]) for i in range(TRAIN_STEPS)]
    for rank in ranks:
        np.testing.assert_allclose(rank[f"t/{name}/losses"], want, rtol=0,
                                   atol=TRAIN_TOL)
    last = TRAIN_STEPS - 1
    keys = _leaf_keys(f"t/{name}/params/", ranks[0])
    assert keys == _leaf_keys(f"t/{name}/{last}/params/", jax)
    quantized = sync["mode"] in ("optinc", "cascade")
    for r, rank in enumerate(ranks):
        for k in keys:
            got = rank[f"t/{name}/params/{k}"]
            exp = jax[f"t/{name}/{last}/params/{k}"][r]
            diff = np.abs(got - exp)
            if quantized:
                assert diff.max() <= 2 * TRAIN_STEPS * LR, k
                assert (diff > TRAIN_TOL).mean() < 1e-3, k
            else:
                assert diff.max() <= TRAIN_TOL, k


def test_stacked_fsdp_equals_the_processes_bit_for_bit(runs):
    """The cascade over 2 pods with --fsdp: the stacked session (each
    data index's shards stacked, the pod's bf16 sum in data order;
    one tree, as every session's state) gives the 4
    gloo ranks' losses and every rank's shards bit for bit."""
    name = "cascade_fsdp"
    pods, dp, tp = TRAIN_CASES[name][:3]
    cfg = f32_cfg("llama3_405b")
    s = run_spec(name)
    g = tree_of({k[len(f"t/{name}/params/"):]: v for k, v in
                 runs["inp"].items() if k.startswith(f"t/{name}/params/")})
    params = unflatten(g, [torch.from_numpy(a) for a in leaves(g)])
    sess = tapi.TrainSession(s, callbacks=[], device="cpu", params=params,
                             cfg=cfg)
    sess.run()
    ranks = runs["ranks"][(pods, dp, tp)]
    for rank in ranks:
        assert list(rank[f"t/{name}/losses"]) == [sess.losses[i] for i in
                                                  range(TRAIN_STEPS)]
    for r, rank in enumerate(ranks):
        mine = tree_map(lambda t: t[r % dp], sess.params)
        for path, t in leaves_with_paths(mine):
            assert np.array_equal(rank[f"t/{name}/params/" + "/".join(path)],
                                  t.numpy()), (r, path)
        for k, v in sess.sync_state.items():
            assert np.array_equal(rank[f"t/{name}/residual/{k}"],
                                  v[r:r + 1].numpy()), k


# ---------------------------------------------------- checkpoints
@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_global_state_goes_to_rank_0_alone(runs, name):
    """``steps.to_global`` over the ranks (what a checkpoint saves): rank
    0 gets the global leaves on its host, the others only send the
    shards of their sharded leaves and get None."""
    pods, dp, tp, fsdp, _ = TRAIN_CASES[name]
    cfg, ctx = f32_cfg("llama3_405b"), ctx_of(pods, dp, tp, fsdp)
    sizes = {"pod": pods, "data": dp, "model": tp}
    shard_bytes = 4 * sum(
        int(np.prod(shp)) for shp, sp in zip(
            leaves(tlm.local_param_shapes(cfg, ctx)), tlm.spec_leaves(cfg, ctx))
        if any(ax is not None and sizes[ax] > 1 for ax in sp))
    assert shard_bytes
    for r, rank in enumerate(runs["ranks"][(pods, dp, tp)]):
        assert list(rank[f"t/{name}/global_devices"]) == (
            ["cpu"] if r == 0 else []), r
        assert int(rank[f"t/{name}/global_sent"]) == shard_bytes, r


def test_port_sharded_checkpoint_loads_in_jax(runs):
    """The 2 x 2 FSDP run's checkpoint, written by rank 0 from the
    gathered shards, reads in JAX's ``load_checkpoint`` at JAX's global
    shapes; the params are JAX's run's global arrays within the
    trainer's bounds, and the residuals are the ranks' rows in rank
    order."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint import load_checkpoint, read_manifest
    from repro.models import lm as jlm
    from repro.models.layers import ShardCtx as JCtx
    name = CKPT_CASE
    pods, dp, tp, fsdp, _ = TRAIN_CASES[name]
    direc = runs["dir"] / f"port_ckpt_{name}"
    step = TRAIN_STEPS - 1
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3_405b"),
                               dtype="float32")
    _, shapes = jlm.param_specs(jcfg, JCtx(tp=tp, dp=dp, pods=pods,
                                          fsdp=fsdp))
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    man = read_manifest(direc, step)
    template = {"params": zeros, "opt": {"m": zeros, "v": zeros,
                                         "step": np.zeros((), np.int32)},
                "sync": {k: np.zeros(tuple(man["leaves"][f"sync/{k}"][
                    "shape"]), np.float32) for k in ("rep", "fsdp")}}
    tree, _ = load_checkpoint(direc, step, template)
    ranks = runs["ranks"][(pods, dp, tp)]
    ctx = ctx_of(pods, dp, tp, fsdp)
    specs = dict(zip(["/".join(p) for p, _ in leaves_with_paths(
        tlm.param_shapes(f32_cfg("llama3_405b"), ctx))],
        tlm.spec_leaves(f32_cfg("llama3_405b"), ctx)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree["params"]):
        k = "/".join(p.key for p in path)
        shards = torch.from_numpy(np.stack(
            [rk[f"t/{name}/params/{k}"] for rk in ranks]))
        mine = tlm.assemble_leaf(shards, specs[k], ctx).numpy()
        assert np.array_equal(np.asarray(a), mine), k
        jglob = tlm.assemble_leaf(torch.from_numpy(
            runs["jax"][f"t/{name}/{step}/params/{k}"]), specs[k],
            ctx).numpy()
        assert np.abs(np.asarray(a) - jglob).max() <= 2 * TRAIN_STEPS * LR
    assert int(tree["opt"]["step"]) == TRAIN_STEPS
    for k in ("rep", "fsdp"):
        rows = np.concatenate([rk[f"t/{name}/residual/{k}"] for rk in ranks])
        assert np.array_equal(np.asarray(tree["sync"][k]), rows.reshape(-1))


def test_jax_sharded_checkpoint_resumes_in_the_port(runs):
    """JAX's checkpoint of the same run, resumed by 4 gloo ranks: every
    rank holds JAX's device values bit for bit (its shards, and of a
    replicated leaf device 0's copy, as JAX's save keeps), the AdamW
    moments too, and its residual rows; the run resumes after the
    saved step."""
    name = CKPT_CASE
    pods, dp, tp = TRAIN_CASES[name][:3]
    jax = runs["jax"]
    ctx = ctx_of(pods, dp, tp, TRAIN_CASES[name][3])
    cfg = f32_cfg("llama3_405b")
    specs = dict(zip(["/".join(p) for p, _ in leaves_with_paths(
        tlm.param_shapes(cfg, ctx))], tlm.spec_leaves(cfg, ctx)))
    for r, rank in enumerate(runs["resume"]):
        assert int(rank["resume/step"]) == TRAIN_STEPS
        for part in ("params", "m", "v"):
            for k, sp in specs.items():
                dev = jax[f"c/{part}/{k}"]
                want = dev[r] if any(a is not None for a in sp) else dev[0]
                assert np.array_equal(rank[f"resume/{part}/{k}"], want), (
                    r, part, k)
        for k in ("rep", "fsdp"):
            vec = jax[f"t/{name}/{TRAIN_STEPS - 1}/residual/{k}"]
            n = vec.size // (pods * dp * tp)
            assert np.array_equal(rank[f"resume/residual/{k}"][0],
                                  vec[r * n:(r + 1) * n]), k


# ------------------------------------------------------- remat groups
@pytest.mark.parametrize("groups", [2, 4])
def test_remat_groups_equal_no_remat(groups):
    """JAX's two-level remat (groups of n / g checkpointed layers, each
    layer checkpointed too; g = 4 on 4 layers is the flat per-layer
    form) recomputes the same numbers: loss and every gradient bit for
    bit against no remat, and each checkpoint around a layer runs its
    forward once more (whole regions, no early stop)."""
    from repro_torch.kernels import ref
    cfg = f32_cfg("llama3_405b")
    g = tree_of(make_params("llama3_405b", ShardCtx(), 5))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 17)))
    calls = []
    fwd = ref.attention_fwd_ref

    def counted(*a, **k):
        calls.append(1)
        return fwd(*a, **k)

    out = []
    for ctx in (ShardCtx(), ShardCtx(remat_groups=groups)):
        params = [torch.from_numpy(a).requires_grad_() for a in leaves(g)]
        calls.clear()
        ref.attention_fwd_ref = counted
        try:
            loss, _ = tlm.loss_fn(cfg, unflatten(g, params),
                                  {"tokens": tokens}, ctx)
            grads = torch.autograd.grad(loss, params)
        finally:
            ref.attention_fwd_ref = fwd
        out.append((loss, grads, len(calls)))
    (l0, g0, c0), (l1, g1, c1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c0 == cfg.n_layers
    assert c1 == (3 if groups == 2 else 2) * cfg.n_layers


# ----------------------------------------------------------- refusals
def test_tp_needs_processes_and_the_world_its_size(monkeypatch):
    """tp > 1 without the launch environment names torch.distributed.run;
    a launch whose WORLD_SIZE is not pods * dp * tp names both numbers."""
    s = run_spec("psum_tp")
    with pytest.raises(tapi.SpecError, match="torch.distributed.run"):
        tapi.TrainSession(s, device="cpu")
    for k, v in dict(WORLD_SIZE=2, RANK=0, LOCAL_RANK=0).items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(tapi.SpecError,
                       match=r"WORLD_SIZE 2 != mesh.peers 2 x mesh.tp 2 = 4"):
        tapi.TrainSession(s, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh", [dict(fsdp=True), dict(tp=2)])
def test_overlap_with_sharding_and_seq_parallel_are_refused(mesh):
    base = run_spec("psum_tp").to_json_dict()
    base["mesh"] = {**base["mesh"], "tp": 1, **mesh}
    base["sync"] = {**base["sync"], "overlap": True}
    with pytest.raises(tapi.SpecError, match="--overlap .* --fsdp or tp"):
        tapi.RunSpec.from_json_dict(base).validate()
    base["sync"]["overlap"] = False
    base["mesh"]["seq_parallel"] = True
    with pytest.raises(tapi.SpecError, match=r"5\.583917.*5\.571617"):
        tapi.RunSpec.from_json_dict(base).validate()
