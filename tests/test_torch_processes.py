"""Peers as processes (``repro_torch.launch.distributed``) on the CPU,
gloo ranks, held against the stacked port and the JAX package.

The worlds are spawned once for the module, N = 1, 2, 3, 4 and 2 pods x
2, each rank one process with the launch environment torchrun sets and
torch pinned to one thread.  Each spawn has its own time limit and
kills its processes, so a deadlock fails the tests instead of stalling
the suite.  On the same numpy-seeded buckets every backend's process
sync is bit-equal to the stacked port's (psum within PSUM_ULPS of the
per-element magnitude: gloo and NCCL sum in their own order) and, where
the JAX subprocess references of ``test_torch_collectives.py`` and
``test_torch_sync_modes.py`` hold the bucket, to JAX's (their scripts
run here in two subprocesses, beside the worlds).  Table-II injection
runs on JAX's own draws in the ranks and on the stacked path.

The trainers go through the real entry point, ``python -m
torch.distributed.run -m repro_torch.launch.train --device cpu``: 2
ranks of minitron_4b's smoke config for 3 steps give rank 0's whole
losses and a checkpointed final state bit-equal to the stacked
TrainSession's, a world of one the stacked 1-peer run's, and a
checkpoint resumes across the two modes.

The ranks' code (``RANK_LIB``) imports nothing of JAX; the parent runs
the same code for the stacked path.
"""
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_api as tapi_tests
import test_torch_collectives as tc
import test_torch_sync_modes as ts
from repro_torch import api as tapi
from repro_torch.checkpoint import latest_step
from repro_torch.collectives import engine
from repro_torch.kernels import _build
from repro_torch.launch import distributed, train
from repro_torch.photonics import runtime
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {"n1": (1, 1), "n2": (1, 2), "n3": (1, 3), "n4": (1, 4),
          "p2x2": (2, 2)}
SPAWN_TIMEOUT_S = 420     # one spawn: its processes are killed after this
FAIL_PG_TIMEOUT_S = 60    # the process-group timeout of the failing world
# psum: an f32 sum of N values in two orders differs by at most
# 2 (N - 1) u sum|x_i| (u = 2^-24) and the division by N rounds once;
# in units of spacing(sum|x_i| / N) >= u sum|x_i| / N that is 2N - 1
PSUM_ULPS = 7

# the sync cases: (mode, bits, error feedback, fidelity, mesh backend,
# Table-II row, inputs, worlds).  Inputs "coll" are the buckets of
# test_torch_collectives (its JAX reference holds 1, 2 and 4 peers),
# "small"/"big" those of test_torch_sync_modes (JAX reference on its
# SYNC_CASES grid), "bucket" one bucket of 1001 elements in one block
# (block 0: shards of ceil(1001 / N) codes, odd at N = 2 and 4)
CASES = {
    **{k: (m, b, ef, "behavioral", "xla", (), "coll",
           ("n1", "n2", "n3", "n4", "p2x2"))
       for k, (m, b, ef) in tc.CASES.items()},
    **{k: ("optinc", b, ef, "onn", "xla", (), "coll", ("n1", "n2", "n4"))
       for k, (b, ef) in tc.ONN_CASES.items()},
    **{k: ("optinc", b, ef, "mesh", be, (), "coll", ("n2", "n4"))
       for k, (b, ef, be) in tc.MESH_CASES.items()},
    **{k: (m, b, ef, fid, "xla", tuple(layers), inputs,
           ("p2x2" if pods == 2 else f"n{dp}",))
       for k, (m, b, ef, fid, pods, dp, layers, inputs)
       in ts.SYNC_CASES.items()},
    "block0_8": ("optinc", 8, False, "behavioral", "xla", (), "bucket",
                 ("n2", "n3", "n4", "p2x2")),
    "block0_2_ef": ("optinc", 2, True, "behavioral", "xla", (), "bucket",
                    ("n2", "n3", "n4")),
    "cascade_block0_ef": ("cascade", 8, True, "behavioral", "xla", (),
                          "bucket", ("p2x2",)),
}
# the ring of test_torch_sync_modes.RING: one raw bucket, no engine
RING = {w: ts.RING[w] for w in ("n2", "n3", "n4", "p2x2")}
# the trainers: RunSpec overrides of test_torch_api.tiny (minitron_4b
# smoke, seq 32, global batch 4, 2 peers), TRAIN_STEPS steps on 2 ranks
TRAINERS = {
    "optinc_ef": dict(sync=dict(error_feedback=True)),
    "ring": dict(sync=dict(mode="ring")),
    "cascade": dict(mesh=dict(dp=1, pods=2), sync=dict(mode="cascade")),
    "overlap": dict(sync=dict(overlap=True, error_feedback=True)),
}
TRAIN_STEPS = 3
RESUME_STEPS = 5

RANK_LIB = textwrap.dedent('''
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.collectives import backends, engine
    from repro_torch.launch.mesh import sync_axes
    from repro_torch.photonics import PhotonicsConfig, error_model, runtime
    from repro_torch.photonics import onn as tonn
    from repro_torch.photonics.module import ONNModule


    def t(a):
        return torch.from_numpy(np.array(a))


    def sync_cfg(case, pods):
        mode, bits, ef, fid, be, layers, inputs, _ = case
        if inputs in ("coll", "small"):
            kw = dict(block=128, bucket_bytes=4096)
        elif inputs == "big":
            kw = dict(block=128, bucket_bytes=1 << 18)
        else:
            kw = dict(block=0, bucket_bytes=1 << 20)
        return engine.SyncConfig(
            mode=mode, axes=sync_axes(pods), bits=bits, error_feedback=ef,
            error_layers=tuple(layers),
            photonics=PhotonicsConfig(fidelity=fid, mesh_backend=be), **kw)


    def grad_tree(inp, inputs, step, rows):
        """The gradient tree of the peers ``rows`` (a slice of 4)."""
        if inputs == "bucket":
            return [t(inp["bucket"][rows])]
        p = "" if inputs == "coll" else inputs + "_"
        return {"a": t(inp[p + f"a{step}"][rows]),
                "b": t(inp[p + f"b{step}"][rows]),
                "c": {"d": t(inp[p + f"d{step}"][rows])}}


    def flat(synced):
        if isinstance(synced, list):
            return synced[0].reshape(-1).numpy()
        return torch.cat([synced["a"].reshape(-1), synced["b"].reshape(-1),
                          synced["c"]["d"].reshape(-1)]).numpy()


    def install_onns(inp, n):
        """The bits-8 ONNs of test_torch_collectives for n peers: its
        seeded dense ONN and its seeded Sigma_a U_a mesh ONN."""
        ph = PhotonicsConfig(fidelity="onn")
        runtime.put_module(ph, 8, n, ONNModule.from_params(
            runtime.onn_config(ph, 8, n),
            [{"w": t(inp[f"onn_w{i}"]), "b": t(inp[f"onn_b{i}"])}
             for i in range(6)]))
        module = ONNModule.from_params(tonn.ONNConfig(
            structure=tuple(int(x) for x in inp["mesh_structure"]),
            approx_layers=tuple(int(x) for x in inp["mesh_approx"]),
            bits=8, n_servers=n, k_inputs=4),
            [{"w": t(inp[f"mesh_w{i}"]), "b": t(inp[f"mesh_b{i}"])}
             for i in range(4)])
        for backend in ("xla", "pallas"):
            runtime.put_module(PhotonicsConfig(fidelity="mesh",
                                               mesh_backend=backend),
                               8, n, module)


    class JaxDraws:
        """``error_model.draws`` fed JAX's draws of one step ("<key>/hit<b>"
        and "<key>/which<b>" of ``inp``), bucket by bucket; the shapes
        asked for are kept."""

        def __init__(self, inp, key):
            self.inp, self.key, self.shapes = inp, key, []

        def __call__(self, key, shape, spec, device="cpu"):
            b = len(self.shapes)
            self.shapes.append(tuple(shape))
            return (t(self.inp[f"{self.key}/hit{b}"]),
                    t(self.inp[f"{self.key}/which{b}"]))


    def run_case(name, case, inp, pods, rows, world=None):
        """Two steps of ``case`` over the peers ``rows``: the stacked
        sync, or this rank's row with ``world``.  Returns {"<step>/synced",
        "<step>/residual" (the rows), "<step>/shapes" (the draws')}."""
        ef, layers, inputs = case[2], case[5], case[6]
        cfg = sync_cfg(case, pods)
        keyed = inputs in ("small", "big")      # the sync-modes cases
        res, out = None, {}
        for step in (1, 2):
            tree = grad_tree(inp, inputs, step, rows)
            if ef and res is None:
                parts = (tree if isinstance(tree, list)
                         else [tree["a"], tree["b"], tree["c"]["d"]])
                res = torch.zeros((rows.stop - rows.start,
                                   sum(x[0].numel() for x in parts)))
            draws = JaxDraws(inp, f"{name}/{step}")
            old, error_model.draws = error_model.draws, (
                draws if layers else error_model.draws)
            try:
                synced, res = engine.sync_gradients(
                    tree, cfg, res, key=prng.PRNGKey(step) if keyed else None,
                    pods=pods, world=world)
            finally:
                error_model.draws = old
            out[f"{step}/synced"] = flat(synced)
            if res is not None:
                out[f"{step}/residual"] = res.numpy()
            out[f"{step}/shapes"] = np.array(draws.shapes, np.int64)
        return out


    def run_ring(inp, pods, rows, world=None):
        x = t(inp["bucket"][rows])
        cfg = engine.SyncConfig(mode="ring", axes=sync_axes(pods))
        if world is None:
            x = engine.peer_view(x, cfg, pods)
        return backends.RingBackend().sync(x, cfg, None, world)[0].numpy()
''')

RANK_MAIN = textwrap.dedent('''
    import datetime, json, os, sys
    torch.set_num_threads(1)
    from repro_torch.launch import distributed

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(spec["inputs"]))
    world = distributed.init(spec["pods"], spec["dp"], 1, "cpu",
                             datetime.timedelta(seconds=spec["pg_timeout"]))
    r = world.rank
    if spec.get("stop"):
        from repro_torch import api

        class StopOnRank1(api.Callback):
            def on_step(self, session, record):
                if session.rank == 1 and record["step"] == 0:
                    session.request_stop()

        s = api.RunSpec.load(spec["stop"])
        sess = api.TrainSession(s, callbacks=[
            StopOnRank1(), api.PeriodicCheckpoint(s.ckpt.every)],
            device="cpu")
        recs = sess.run()
        np.savez(os.path.join(spec["out"], f"rank{r}.npz"),
                 steps=np.array([x["step"] for x in recs]))
        distributed.exit_rank(0)
    if spec["fail"]:
        if r == 1:
            raise RuntimeError("rank 1 fails before its collective")
        world.psum(torch.ones(4), ("data",))
        raise SystemExit("rank 0 got through its collective")
    out, rows = {}, slice(r, r + 1)
    install_onns(inp, world.size)
    for name, case in spec["cases"].items():
        before = dict(world.bytes)
        got = run_case(name, case, inp, spec["pods"], rows, world)
        out.update({f"{name}/{k}": v for k, v in got.items()})
        out[f"{name}/bytes"] = np.array(json.dumps(
            {k: v - before.get(k, 0) for k, v in world.bytes.items()
             if v != before.get(k, 0)}))
    if spec["ring"]:
        out["ring"] = run_ring(inp, spec["pods"], rows, world)
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')

LIB = {}
exec(RANK_LIB, LIB)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' thread count
    yield
    torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    from conftest import subprocess_env
    return subprocess_env(OMP_NUM_THREADS="1", **extra)


def _spawn_world(spec: dict, n: int) -> list:
    """Start the n ranks of one world with the launch environment."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_LIB + RANK_MAIN, json.dumps(spec)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return procs


def _torchrun(nproc: int, argv: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         *argv, "--device", "cpu"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _wait(procs: dict, deadline: float) -> dict:
    """{name: [Popen]} -> {name: [(returncode, output)]}, every
    process killed with its process group (a torchrun's ranks too) once
    ``deadline`` has passed."""
    out = {}
    for name, group in procs.items():
        res = []
        for p in group:
            try:
                o, e = p.communicate(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                o, e = p.communicate()
                o = (o or "") + "\n[killed at the spawn's time limit]"
            res.append((p.returncode, (o or "") + (e or "")))
        out[name] = res
    return out


def _jax_procs(d: Path, inputs_c: dict, inputs_s: dict) -> dict:
    """The JAX references of test_torch_collectives and
    test_torch_sync_modes (their scripts and specs, without the
    trainers), each its own subprocess with four host devices."""
    np.savez(d / "jc_in.npz", **inputs_c)
    np.savez(d / "js_in.npz", **inputs_s)
    cases = {k: v + ("behavioral", "xla", tc.PEERS)
             for k, v in tc.CASES.items()}
    cases.update({k: ("optinc", b, ef, "onn", "xla", tc.PEERS)
                  for k, (b, ef) in tc.ONN_CASES.items()})
    cases.update({k: ("optinc", b, ef, "mesh", be, tc.MESH_PEERS)
                  for k, (b, ef, be) in tc.MESH_CASES.items()})
    spec = {"ring": ts.RING, "sync": ts.SYNC_CASES,
            "small_kw": ts.SYNC_KW, "big_kw": ts.BIG_KW,
            "narrow": ts.NARROW, "steps": 0, "train": {}}
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("OMP_NUM_THREADS")
    run = [(tc.JAX_SYNC_SCRIPT, "jc", cases), (ts.JAX_SCRIPT, "js", spec)]
    return {name: [subprocess.Popen(
        [sys.executable, "-c", script, str(d / f"{name}_in.npz"),
         str(d / f"{name}_out.npz"), json.dumps(arg)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)]
        for script, name, arg in run}


def _spec_file(d: Path, name: str, steps: int, ckpt=None, resume=False,
               **kw) -> Path:
    """A RunSpec file: test_torch_api's tiny run with ``kw``, checkpoints
    every TRAIN_STEPS steps into ``ckpt`` when given."""
    if ckpt is not None:
        kw["ckpt"] = dict(dir=str(ckpt), every=TRAIN_STEPS, resume=resume)
    path = d / f"{name}.json"
    tapi_tests.spec(steps=steps, **kw).save(path)
    return path


def _stacked(path: Path):
    """The stacked TrainSession of a spec file, run to its end."""
    s = tapi.RunSpec.load(path)
    sess = tapi.TrainSession(s, callbacks=[tapi.PeriodicCheckpoint(
        s.ckpt.every)], device="cpu")
    sess.run()
    return sess


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything this module spawns, once: the two JAX references and
    the gloo worlds together, then the torchrun trainers (whose resume
    starts from a stacked checkpoint made meanwhile).  Returns the
    inputs, the JAX outputs, each world's per-rank outputs, the
    trainers' runs and the stacked sessions."""
    d = tmp_path_factory.mktemp("processes")
    inp_c, inp_s = tc._sync_inputs(), ts._inputs()
    inp = {**inp_c, **inp_s}
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = _jax_procs(d, inp_c, inp_s)
    jax_out = _wait(procs, deadline)
    for name, [(rc, log)] in jax_out.items():
        assert rc == 0, log[-3000:]
    jax = {**dict(np.load(d / "jc_out.npz")), **dict(np.load(d / "js_out.npz"))}
    # JAX's injection draws, for the ranks and the stacked path alike
    inp.update({k: v for k, v in jax.items()
                if "/hit" in k or "/which" in k})
    np.savez(d / "in.npz", **inp)

    # the gloo worlds, the failing world and the stacked checkpoint
    # the process resume starts from, all at once
    procs, t0 = {}, time.time()
    deadline = t0 + SPAWN_TIMEOUT_S
    for w, (pods, dp) in WORLDS.items():
        out = d / w
        out.mkdir()
        spec = {"inputs": str(d / "in.npz"), "out": str(out), "pods": pods,
                "dp": dp, "pg_timeout": 300, "fail": False,
                "ring": w in RING,
                "cases": {k: c for k, c in CASES.items() if w in c[7]}}
        procs[w] = _spawn_world(spec, pods * dp)
    fail = _spawn_world({"inputs": str(d / "in.npz"), "pods": 1, "dp": 2,
                         "pg_timeout": FAIL_PG_TIMEOUT_S, "fail": True}, 2)
    (d / "stop").mkdir()
    stop = _spawn_world({"inputs": str(d / "in.npz"), "out": str(d / "stop"),
                         "pods": 1, "dp": 2, "pg_timeout": FAIL_PG_TIMEOUT_S,
                         "fail": False, "stop": str(_spec_file(
                             d, "stop", 6, ckpt=d / "stop" / "ck"))}, 2)
    fail = _wait({"fail": fail, "stop": stop}, deadline)
    fail_seconds = time.time() - t0
    stacked = {}
    for name, kw in TRAINERS.items():
        steps = RESUME_STEPS if name == "optinc_ef" else TRAIN_STEPS
        stacked[name] = _stacked(_spec_file(d, f"s_{name}", steps,
                                            ckpt=d / f"s_{name}", **kw))
    # the stacked optinc_ef run's step-2 checkpoint alone: the process
    # resume starts there
    shutil.copytree(d / "s_optinc_ef", d / "p_resume")
    shutil.rmtree(d / "p_resume" / f"step_{RESUME_STEPS - 1}")
    worlds = {**_wait(procs, deadline), **fail}

    # the trainers, through torchrun
    procs, deadline = {}, time.time() + SPAWN_TIMEOUT_S
    for name, kw in TRAINERS.items():
        procs[name] = [_torchrun(2, ["--spec", str(_spec_file(
            d, f"p_{name}", TRAIN_STEPS, ckpt=d / f"p_{name}", **kw))])]
    procs["resume"] = [_torchrun(2, ["--spec", str(_spec_file(
        d, "p_resume", RESUME_STEPS, ckpt=d / "p_resume", resume=True,
        **TRAINERS["optinc_ef"]))])]
    procs["world1"] = [_torchrun(1, ["--spec", str(_spec_file(
        d, "p_world1", TRAIN_STEPS, mesh=dict(dp=1),
        **TRAINERS["optinc_ef"]))])]
    trainers = _wait(procs, deadline)
    stacked["world1"] = _stacked(_spec_file(d, "s_world1", TRAIN_STEPS,
                                            mesh=dict(dp=1),
                                            **TRAINERS["optinc_ef"]))
    return dict(dir=d, inp=inp, jax=jax, worlds=worlds,
                fail_seconds=fail_seconds, trainers=trainers,
                stacked=stacked)


def _rank_out(runs, world: str) -> list:
    (pods, dp) = WORLDS[world]
    results = runs["worlds"][world]
    for rc, log in results:
        assert rc == 0, log[-4000:]
    return [dict(np.load(runs["dir"] / world / f"rank{r}.npz"))
            for r in range(pods * dp)]


# ----------------------------------------------------------- the lanes
@pytest.mark.parametrize("k,s,bits", [(2, 501, 8), (3, 342, 8), (4, 251, 8),
                                      (4, 256, 2), (2, 7, 13), (4, 1, 8)])
def test_lanes_pack_unpack_and_carry_free_sums(k, s, bits):
    """Two codes in an int32, the first half of a shard in the low lane:
    the sum of packed rows unpacks to the sum of the rows whenever a
    lane's sum stays below 2^15 (JAX's int16 condition), codes at the
    top of the range included."""
    from repro_torch.collectives.backends import lanes16
    assert lanes16(bits, k) == ((2 ** bits - 2) * k < 2 ** 15)
    top = 2 ** bits - 2 if lanes16(bits, k) else (2 ** 15 - 1) // k
    rng = np.random.default_rng(k * 1000 + s)
    rows = torch.from_numpy(rng.integers(0, top + 1, (k, k * s))
                            .astype(np.int32))
    rows[:, :3] = top                       # the largest sums
    for r in range(k):
        shards = rows[r].view(k, s)
        packed = distributed.pack_lanes(shards)
        assert packed.shape == (k, -(-s // 2)) and packed.dtype == torch.int32
        for i in range(k):
            assert torch.equal(distributed.unpack_lanes(packed[i], s),
                               shards[i])
    packed = torch.stack([distributed.pack_lanes(rows[r].view(k, s))
                          for r in range(k)])
    total = packed.sum(dim=0, dtype=torch.int32)
    for i in range(k):
        assert torch.equal(distributed.unpack_lanes(total[i], s),
                           rows.view(k, k, s)[:, i].sum(0, dtype=torch.int32))
    assert (total >= 0).all()               # the high lane never overflows


def test_scatter_plan_is_jaxs():
    """The reduce-scatter schedule of JAX's backends: optinc over every
    axis in int16 lanes when (2^B - 2) N < 2^15; the cascade 'data' in
    the type of the dp-way sum, then 'pod' in int32."""
    from repro_torch.collectives.backends import _scatter_plan

    class Grid:
        def __init__(self, pods, dp):
            self.sizes = {"pod": pods, "data": dp}

        def axis_size(self, axes):
            axes = (axes,) if isinstance(axes, str) else axes
            return int(np.prod([self.sizes[a] for a in axes]))

    for pods, dp, bits, mode, want in [
            (1, 4, 8, "optinc", [("data", True)]),
            (2, 2, 8, "optinc", [("pod", True), ("data", True)]),
            (1, 200, 8, "optinc", [("data", False)]),
            (1, 4, 16, "optinc", [("data", False)]),
            (2, 2, 8, "cascade", [("data", True), ("pod", False)]),
            (2, 129, 8, "cascade", [("data", True), ("pod", False)]),
            (2, 130, 8, "cascade", [("data", False), ("pod", False)])]:
        cfg = engine.SyncConfig(mode=mode, bits=bits,
                                axes=("pod", "data") if pods > 1
                                else ("data",))
        assert _scatter_plan(cfg, Grid(pods, dp)) == want


# ------------------------------------------------------------- the syncs
def _case_ids():
    return [(n, w) for n, c in CASES.items() for w in c[7]]


@pytest.mark.parametrize("name,world", _case_ids())
def test_process_sync_matches_stacked_and_jax(runs, name, world,
                                              monkeypatch):
    """Two steps of each backend with one rank a peer against the
    stacked port on the same buckets (and JAX's draws): every rank holds
    the same average, bit-equal to the stacked one (psum within
    PSUM_ULPS), each rank's residual row the stacked row; bit-equal to
    the JAX references where they hold the bucket (bits 8 at fidelity
    onn and mesh: the residuals; the averages stay with the stacked
    path, held to JAX near the thresholds by test_torch_collectives)."""
    case = CASES[name]
    pods, dp = WORLDS[world]
    n = pods * dp
    ranks = _rank_out(runs, world)
    inp = runs["inp"]
    monkeypatch.setattr(runtime, "_CACHE", {})
    LIB["install_onns"](inp, n)
    want = LIB["run_case"](name, case, inp, pods, slice(0, n))
    mode, bits, ef, fid, _, layers, inputs, _ = case
    for step in ("1", "2"):
        got = [r[f"{name}/{step}/synced"] for r in ranks]
        assert all(np.array_equal(g, got[0]) for g in got)
        stacked = want[f"{step}/synced"]
        tol = 0.0
        if mode == "psum":
            x = np.concatenate([LIB["flat"](LIB["grad_tree"](
                inp, inputs, int(step), slice(p, p + 1)))[None]
                for p in range(n)])
            tol = PSUM_ULPS * np.spacing(np.abs(x).sum(0) / n)
            assert (np.abs(got[0] - stacked) <= tol).all()
        else:
            np.testing.assert_array_equal(got[0], stacked)
        feedback = ef and mode != "ring"     # the ring keeps no residual
        assert (f"{step}/residual" in want) == feedback
        if feedback:
            rows = np.concatenate([r[f"{name}/{step}/residual"]
                                   for r in ranks])
            np.testing.assert_array_equal(rows, want[f"{step}/residual"])
        if layers:
            # JAX injects on its reduce-scattered shard: ceil(L / N) codes
            # a draw when behavioral, the whole vector when photonic
            shapes = [tuple(s) for s in ranks[0][f"{name}/{step}/shapes"]]
            assert shapes == [tuple(s) for s in want[f"{step}/shapes"]]
            big = ts.BIG
            assert shapes[0] == ((-(-big // 4 // n),) if fid == "behavioral"
                                 else (big // 4,))
        jax = runs["jax"]
        key = (f"{name}/{n}/{step}" if inputs == "coll"
               else f"{name}/{step}")
        if key + "/synced" not in jax:
            continue
        if not (fid in ("onn", "mesh") and bits == 8):
            assert (np.abs(got[0] - jax[key + "/synced"][0]) <= tol).all()
        if feedback:
            np.testing.assert_array_equal(rows, jax[key + "/residual"])


@pytest.mark.parametrize("world", list(RING))
def test_process_ring_is_jaxs_ppermute_ring(runs, world):
    """JAX's _ring_allreduce_flat over 'pod', then 'data', each round a
    send to the next rank of the axis: bit-equal to the stacked ring
    and to JAX's."""
    pods, dp = WORLDS[world]
    ranks = _rank_out(runs, world)
    want = LIB["run_ring"](runs["inp"], pods, slice(0, pods * dp))
    for r in ranks:
        np.testing.assert_array_equal(r["ring"], want)
        np.testing.assert_array_equal(r["ring"],
                                      runs["jax"][f"ring/{world}"][0])


@pytest.mark.parametrize("world", ["n2", "n4", "p2x2"])
def test_wire_bytes_are_two_bytes_a_code_scattered_one_gathered(runs,
                                                                 world):
    """optinc at bits 8 with JAX's int16 choice, two steps of 4 buckets:
    each stage of the reduce-scatter plan ('pod', then 'data') takes 2
    bytes a code of its input (16-bit lanes, as JAX's int16), each
    all-gather gives 1 byte a code (uint8), and the shared scale is one
    f32 a block and axis; nothing else crosses."""
    pods, dp = WORLDS[world]
    codes = 1024                   # each bucket: 8 blocks of 128 codes
    want = {"psum_scatter:int32": 0, "all_gather:uint8": 0,
            "pmax:float32": 0}
    for k in (pods, dp):
        if k > 1:
            want["psum_scatter:int32"] += 2 * 4 * 2 * codes
            want["all_gather:uint8"] += 2 * 4 * codes
            want["pmax:float32"] += 2 * 4 * 8 * 4
            codes //= k
    for r in _rank_out(runs, world):
        assert json.loads(str(r["optinc8/bytes"])) == want


def test_a_stop_asked_on_one_rank_is_agreed_by_all(runs):
    """Rank 1 alone asks for a stop after step 0: every rank runs step
    1, agrees on the stop after it, and writes the stop's checkpoint
    together (none waits for a collective the other skipped)."""
    for rc, log in runs["worlds"]["stop"]:
        assert rc == 0, log[-3000:]
    for r in range(2):
        got = np.load(runs["dir"] / "stop" / f"rank{r}.npz")["steps"]
        assert got.tolist() == [0, 1]
    assert latest_step(runs["dir"] / "stop" / "ck") == 1


def test_a_rank_that_raises_fails_the_others(runs):
    """Rank 1 raises after the group starts; rank 0, in a collective,
    fails within the process-group timeout instead of hanging."""
    res = runs["worlds"]["fail"]
    assert all(rc != 0 for rc, _ in res), [log for _, log in res]
    assert "rank 1 fails" in res[1][1]
    assert "got through" not in res[0][1]
    assert runs["fail_seconds"] < FAIL_PG_TIMEOUT_S + 60


def test_stream_of_processes_keeps_the_static_launch_order(monkeypatch):
    """Every rank must issue its collectives in one order: with a world,
    a bucket whose leaves are ready waits for every earlier bucket of
    ``launch_order``; without one, it goes as soon as it is ready."""
    from repro_torch.collectives import bucketizer
    launched = []
    monkeypatch.setattr(engine, "_bucket_sync",
                        lambda b, f, r, bounds, *a: (
                            launched.append(bounds) or
                            (f.new_zeros(bounds[1] - bounds[0]), None)))
    layout = bucketizer.make_layout([torch.empty(300), torch.empty(500),
                                     torch.empty(100), torch.empty(400)],
                                    bucket_bytes=1600)
    cfg = engine.SyncConfig(mode="optinc")
    schedule = bucketizer.launch_order(layout)
    for world in (object(), None):
        launched.clear()
        stream = engine.BucketStream(layout, cfg,
                                     torch.zeros(1, layout.total),
                                     world=world)
        for i in (0, 1, 2, 3):       # forward order: against the model
            stream.leaf_ready(i)
        stream.finish()
        order = [layout.bounds.index(b) for b in launched]
        assert sorted(order) == list(range(layout.n_buckets))
        if world is not None:
            assert order == list(schedule)
        else:
            assert order != list(schedule)


# ------------------------------------------------------------- trainers
def _train_out(runs, name):
    """(step records, the rank report) of a torchrun trainer."""
    [(rc, log)] = runs["trainers"][name]
    assert rc == 0, "\n".join(x for x in log.splitlines()
                               if "Warning" not in x and "func(" not in x)
    lines = [json.loads(x) for x in log.splitlines() if x.startswith("{")]
    recs = [x for x in lines if "step" in x]
    [report] = [x for x in lines if "ranks" in x]
    return recs, report


def _arrays(direc: Path, step: int) -> dict:
    return dict(np.load(direc / f"step_{step}" / "arrays.npz"))


@pytest.mark.parametrize("name", list(TRAINERS))
def test_process_trainer_matches_the_stacked_trainer(runs, name):
    """2 ranks through torchrun, 3 steps: rank 0 alone prints the step
    lines, its whole losses are the stacked run's bit for bit, and the
    checkpoint (params, AdamW state, the residuals gathered into JAX's
    layout) is the stacked checkpoint array for array."""
    recs, report = _train_out(runs, name)
    sess = runs["stacked"][name]
    assert [r["step"] for r in recs] == list(range(TRAIN_STEPS))
    assert report["steps"] == TRAIN_STEPS
    assert report["losses"] == [sess.losses[s] for s in range(TRAIN_STEPS)]
    assert [r["loss"] for r in recs] == [round(x, 5)
                                         for x in report["losses"]]
    got = _arrays(runs["dir"] / f"p_{name}", TRAIN_STEPS - 1)
    want = _arrays(runs["dir"] / f"s_{name}", TRAIN_STEPS - 1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["device"] == "cpu" for r in ranks)
    # every rank ran its own peer's forward and backward and the sync
    sent = [r["collective_bytes"] for r in ranks]
    assert sent[0] == sent[1] and sent[0]
    if name == "ring":
        assert "ppermute:float32" in sent[0]
        assert "psum_scatter:int32" not in sent[0]
    else:
        assert "psum_scatter:int32" in sent[0]
        assert "all_gather:uint8" in sent[0]


def test_world_of_one_matches_the_stacked_one_peer_run(runs):
    """torchrun with one process, --mesh 1x1: the stacked 1-peer losses
    bit for bit, and no byte crosses for the sync (every axis has size
    1; the loss gather and the stop flag of each step remain)."""
    recs, report = _train_out(runs, "world1")
    sess = runs["stacked"]["world1"]
    assert report["losses"] == [sess.losses[s] for s in range(TRAIN_STEPS)]
    sent = report["ranks"][0]["collective_bytes"]
    assert set(sent) <= {"all_gather:float32"}, sent


def test_checkpoints_resume_across_stacked_and_processes(runs, tmp_path):
    """A stacked checkpoint resumes on 2 ranks, and the 2 ranks'
    checkpoint resumes stacked: both continue the uninterrupted stacked
    run bit for bit (losses, params, AdamW state, residual rows)."""
    full = runs["stacked"]["optinc_ef"]
    recs, report = _train_out(runs, "resume")
    assert [r["step"] for r in recs] == [3, 4]
    assert report["losses"] == [full.losses[s] for s in (3, 4)]
    got = _arrays(runs["dir"] / "p_resume", RESUME_STEPS - 1)
    want = _arrays(runs["dir"] / "s_optinc_ef", RESUME_STEPS - 1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the processes' step-2 checkpoint, resumed by a stacked session
    shutil.copytree(runs["dir"] / "p_optinc_ef", tmp_path / "ck")
    path = _spec_file(tmp_path, "s", RESUME_STEPS, ckpt=tmp_path / "ck",
                      resume=True, **TRAINERS["optinc_ef"])
    sess = _stacked(path)
    assert [sess.losses[s] for s in (3, 4)] == [full.losses[s]
                                                for s in (3, 4)]
    for a, b in zip(leaves({"p": sess.params, "o": sess.opt_state}),
                    leaves({"p": full.params, "o": full.opt_state})):
        assert torch.equal(a, b)
    assert torch.equal(sess.sync_state["rep"], full.sync_state["rep"])


# ------------------------------------------------------------- refusals
def _launch_env(monkeypatch, world: int, rank: int = 0):
    for k, v in dict(WORLD_SIZE=world, RANK=rank, LOCAL_RANK=rank,
                     LOCAL_WORLD_SIZE=world).items():
        monkeypatch.setenv(k, str(v))


def test_world_size_must_be_pods_times_dp(monkeypatch, tmp_path, capsys):
    """A launch of 3 ranks for a 2-peer spec raises at once, naming both
    numbers (the session, and the CLI's error exit), before any process
    group exists."""
    _launch_env(monkeypatch, 3)
    assert distributed.launched()
    with pytest.raises(tapi.SpecError, match=r"WORLD_SIZE 3 != mesh.peers 2"):
        tapi.TrainSession(tapi_tests.spec(), device="cpu")
    path = _spec_file(tmp_path, "s", 2)
    with pytest.raises(SystemExit, match=r"WORLD_SIZE 3 != mesh.peers 2"):
        train.run(train.parse_args(["--spec", str(path), "--device", "cpu"]))
    assert not torch.distributed.is_initialized()


def test_more_cuda_ranks_than_cards_raise(monkeypatch):
    """Two CUDA ranks on a one-card machine raise before the process is
    bound to a card or a process group starts."""
    _launch_env(monkeypatch, 2, rank=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    called = []
    monkeypatch.setattr(torch.cuda, "set_device", called.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: called.append("pg"))
    with pytest.raises(RuntimeError, match=r"2 CUDA ranks .* 1 card"):
        distributed.init(1, 2, 1, "cuda")
    assert not called


def test_cuda_init_binds_the_card_first_and_rank_0_builds(monkeypatch):
    """On CUDA, init binds cuda:LOCAL_RANK before the process group
    (NCCL, a timeout of minutes), local rank 0 alone builds the kernels,
    and every rank meets at a barrier after the build."""
    import torch.distributed.device_mesh as dm
    for rank in (0, 1):
        _launch_env(monkeypatch, 2, rank)
        calls = []
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: calls.append(("set_device", str(d))))
        monkeypatch.setattr(
            torch.distributed, "init_process_group",
            lambda backend, timeout, device_id: calls.append(
                ("init", backend, timeout.total_seconds(), str(device_id))))
        monkeypatch.setattr(_build, "build",
                            lambda: calls.append(("build",)))
        monkeypatch.setattr(torch.distributed, "barrier",
                            lambda: calls.append(("barrier",)))
        monkeypatch.setattr(dm, "init_device_mesh",
                            lambda *a, **k: calls.append(("mesh", a, k)))
        monkeypatch.setattr(distributed, "ProcessAxes",
                            lambda mesh, device: ("axes", device))
        monkeypatch.setattr(distributed, "_WORLD", None)
        got = distributed.init(1, 2, 1, "cuda")
        dev = f"cuda:{rank}"
        assert got == ("axes", torch.device(dev))
        want = [("set_device", dev),
                ("init", "nccl", distributed.TIMEOUT.total_seconds(), dev)]
        want += [("build",)] if rank == 0 else []
        want += [("barrier",), ("mesh", ("cuda", (1, 2, 1)),
                                {"mesh_dim_names": ("pod", "data",
                                                    "model")})]
        assert calls == want
        assert 60 <= distributed.TIMEOUT.total_seconds() <= 1800
    monkeypatch.setattr(distributed, "_WORLD", None)


def test_device_resolves_to_the_local_card_in_process_mode(monkeypatch):
    from repro_torch import device as device_util
    _launch_env(monkeypatch, 4, rank=3)
    assert device_util.resolve("cuda", "t") == torch.device("cuda", 3)
    assert device_util.resolve("cpu", "t") == torch.device("cpu")
    assert device_util.resolve("cuda:1", "t") == torch.device("cuda", 1)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k)
    assert device_util.resolve("cuda", "t") == torch.device("cuda")


# ----------------------------------------------- kernel launch device
def test_kernel_launchers_make_the_tensors_device_current(monkeypatch):
    """A C entry launches on the current device, so every launcher
    enters ``torch.cuda.device(<the tensors' device>)`` around the call,
    and every wrapper passes its tensors' device."""
    import ast
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(("enter", self.device))

        def __exit__(self, *exc):
            entered.append(("exit", self.device))

    def fake(*args):
        entered.append(("call", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setitem(_build._ENTRIES, ("lib", "sym"), fake)
    dev = torch.device("cuda", 1)
    assert _build.entry("lib", "sym", [])(dev, 7, 8) == 0
    assert entered == [("enter", dev), ("call", (7, 8)), ("exit", dev)]
    # each wrapper's launcher call names a tensor's device first
    calls = 0
    for path in sorted((ROOT / "src/repro_torch/kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        launchers = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                     and isinstance(n.value, ast.Call)
                     and ast.unparse(n.value.func) == "_build.entry"
                     for t in n.targets}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in launchers):
                calls += 1
                first = ast.unparse(n.args[0])
                assert first.endswith(".device"), (path.name, first)
    assert calls == 7             # pam4 x 2, flash x 2, onn, mesh, paged
