"""repro_torch.api on the CPU, held against repro.api: RunSpec's JSON
(a JAX spec's dict in gives the same dict out, both ways), its
refusals, exact stop-and-resume of the port's TrainSession (plain, with
error feedback, with block-sparse residuals, at fidelity onn), resume
across the two packages, the callbacks, the LR schedule, hot reload,
and ServeSession's greedy tokens against JAX's ServeSession.  Every
session here is given ``device='cpu'``."""
import dataclasses
import io
import json
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.layers import ShardCtx
from repro.optim import schedule as jschedule
from repro_torch import api as tapi
from repro_torch.api import callbacks as tcb
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import cosine_schedule
from repro_torch.photonics import runtime
from repro_torch.serving import reload as treload
from repro_torch.serving.engine import ServeEngine
from repro_torch.tree import leaves, tree_map

# the first resumed loss of a bf16 model in the other package: the state
# is carried bit for bit (tests/test_torch_checkpoint.py), but the two
# frameworks order the bf16 matmuls' f32 sums differently and round
# their bf16 activations at other points.  Measured 1.6e-4 and 2.7e-4 on
# a loss of ~4.7; one bf16 rounding of that loss is 2^-8 relative
# (0.018), and the bound sits a tenth of that
CROSS_LOSS_TOL = 2e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny(**kw) -> dict:
    """The JSON dict of the smallest useful run (minitron SMOKE, seq 32),
    which both packages parse."""
    d = dict(arch="minitron_4b", smoke=True, steps=4,
             optim=dict(lr=1e-3),
             data=dict(vocab=0, seq_len=32, global_batch=4, seed=0),
             sync=dict(mode="optinc", bits=8, block=256),
             mesh=dict(dp=2))
    for k, v in kw.items():
        d[k] = {**d[k], **v} if isinstance(v, dict) and k in d else v
    return d


def spec(**kw) -> tapi.RunSpec:
    return tapi.RunSpec.from_json_dict(tiny(**kw))


def jspec(**kw) -> japi.RunSpec:
    return japi.RunSpec.from_json_dict(tiny(**kw))


def _json(s) -> dict:
    return json.loads(s.to_json())


# ------------------------------------------------------------------ spec
@pytest.mark.parametrize("kw", [
    {},
    tiny(),
    tiny(sync=dict(error_feedback=True, sparse_residuals=True,
                   bucket_bytes=1 << 18),
         ckpt=dict(dir="/tmp/x", every=7, keep=2, resume=True),
         watchdog=2.5, log="m.jsonl", seed=3),
    tiny(sync=dict(bits=2, photonics=dict(fidelity="mesh",
                                          mesh_backend="pallas", blk_b=64,
                                          theta_drift_std=0.02))),
    tiny(serve=dict(page_size=4, max_seq=64, reload_every=2,
                    decode_backend="paged", kv_dtype="bf16"),
         ckpt=dict(dir="/tmp/y"), elastic=dict(allow_reshard=True)),
], ids=["defaults", "tiny", "ckpt-ef-sparse", "mesh-noise", "serve-reload"])
def test_runspec_json_is_jax_json(kw):
    """A JAX spec's JSON parses in the port and comes out the same, and
    the port's parses in JAX: the two JSON dicts are equal."""
    j = japi.RunSpec.from_json_dict(kw).validate()
    t = tapi.RunSpec.from_json_dict(_json(j)).validate()
    assert _json(t) == _json(j)
    assert _json(japi.RunSpec.from_json(t.to_json())) == _json(t)
    assert tapi.RunSpec.from_json(t.to_json()) == t
    assert isinstance(t.sync.axes, tuple)
    assert t.state_fingerprint() == j.state_fingerprint()
    assert t.shape_fingerprint() == j.shape_fingerprint()


def test_runspec_rejects_unknown_keys_and_bad_specs(tmp_path):
    d = tapi.RunSpec().to_json_dict()
    d["typo_field"] = 1
    with pytest.raises(tapi.SpecError, match="typo_field"):
        tapi.RunSpec.from_json_dict(d)
    d2 = tapi.RunSpec().to_json_dict()
    d2["mesh"]["pod"] = 2
    with pytest.raises(tapi.SpecError, match="MeshSpec"):
        tapi.RunSpec.from_json_dict(d2)
    for kw, match in ((dict(arch="no_such_model"), "arch"),
                      (dict(mesh=dict(dp=3)), "divisible"),
                      (dict(ckpt=dict(resume=True)), "resume"),
                      (dict(steps=0), "steps"),
                      (dict(sync=dict(sparse_residuals=True)),
                       "error-feedback"),
                      (dict(serve=dict(reload_every=1)), "ckpt-dir"),
                      (dict(serve=dict(top_k=3)), "temperature"),
                      (dict(sync=dict(photonics=dict(blk_b=64))), "blk-b")):
        with pytest.raises(tapi.SpecError, match=match):
            spec(**kw).validate()
        with pytest.raises(japi.SpecError, match=match):
            jspec(**kw).validate()
    with pytest.raises(tapi.SpecError, match="not valid JSON"):
        (tmp_path / "bad.json").write_text("{")
        tapi.RunSpec.load(tmp_path / "bad.json")


@pytest.mark.parametrize("kw,name", [
    # taken since FSDP/TP were ported (name = a check of the spec); tp > 1
    # runs as processes (RunSpec.check_launch)
    pytest.param(dict(mesh=dict(tp=2)),
                 lambda s: (s.mesh.tp, s.mesh.devices) == (2, 4),
                 id="kw0-tensor parallelism"),
    pytest.param(dict(mesh=dict(fsdp=True)), lambda s: s.mesh.ctx().fsdp,
                 id="kw2-FSDP"),
    pytest.param(dict(mesh=dict(seq_parallel=True)), "seq_parallel",
                 id="kw3-seq_parallel"),
    pytest.param(dict(mesh=dict(remat_groups=2)),
                 lambda s: s.mesh.ctx().remat_groups == 2,
                 id="kw4-remat_groups"),
    pytest.param(dict(elastic=dict(enabled=True)), "elastic.enabled",
                 id="kw9-elastic.enabled"),
    pytest.param(dict(elastic=dict(evict_after=3)), "evict_after",
                 id="kw10-evict_after"),
    pytest.param(dict(elastic=dict(heartbeat_s=2.0)), "heartbeat_s",
                 id="kw11-heartbeat_s"),
    pytest.param(dict(optim=dict(moment_dtype="bfloat16")), "moment_dtype",
                 id="kw12-moment_dtype"),
])
def test_runspec_refuses_what_is_not_ported_by_name(kw, name, tmp_path):
    """Each field the port does not run yet, from a JAX spec's JSON (a
    spec JAX itself takes) and from a --spec file through the CLI; the
    fields it runs now parse both ways."""
    d = tiny(**kw)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(d))
    if callable(name):
        assert name(tapi.RunSpec.from_json_dict(d).validate())
        assert name(train.parse_args(["--spec", str(path)]).spec)
        return
    with pytest.raises(tapi.SpecError, match=name):
        tapi.RunSpec.from_json_dict(d).validate()
    with pytest.raises(SystemExit, match=name):
        train.parse_args(["--spec", str(path)])


@pytest.mark.parametrize("kw", [
    pytest.param(dict(mesh=dict(pods=2)), id="pods-2"),
    pytest.param(dict(mesh=dict(pods=4, dp=1), sync=dict(mode="cascade")),
                 id="cascade-pods-4"),
    pytest.param(dict(sync=dict(mode="ring")), id="ring"),
    pytest.param(dict(mesh=dict(pods=2, dp=1), sync=dict(
        mode="cascade", bits=2, photonics=dict(fidelity="onn"))),
        id="cascade-onn"),
    pytest.param(dict(sync=dict(overlap=True, error_feedback=True)),
                 id="overlap"),
    pytest.param(dict(sync=dict(error_layers=[3, 4, 5, 6])),
                 id="error_layers"),
])
def test_runspec_takes_the_sync_modes_jax_takes(kw, tmp_path):
    """Each field that earlier slices refused (mesh.pods, ring, cascade,
    overlap, error_layers): a JAX spec's JSON validates in the
    port with JAX's JSON, and a --spec file of it builds and trains one
    step on the CPU over pods * dp peers."""
    d = tiny(**kw)
    j = japi.RunSpec.from_json_dict(d).validate()
    t = tapi.RunSpec.from_json_dict(d).validate()
    assert _json(t) == _json(j)
    assert t.resolved_sync().axes == j.resolved_sync().axes
    assert tapi.modeled_bytes_on_wire(t) == japi.modeled_bytes_on_wire(j)
    for ov in (False, True):
        assert tapi.modeled_time_on_wire(t, overlap=ov) == \
            japi.modeled_time_on_wire(j, overlap=ov)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(d))
    opts = train.parse_args(["--spec", str(path), "--steps", "1",
                             "--device", "cpu"])
    sess = tapi.TrainSession(opts.spec, callbacks=[], device="cpu")
    assert sess.peers == t.mesh.pods * t.mesh.dp
    recs = sess.run()
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"])


def test_from_args_overlays_flags_and_spec_file(tmp_path):
    s = tapi.RunSpec.from_args(
        ["--arch", "minitron_4b", "--smoke-config", "--mesh", "2x1",
         "--steps", "7", "--seq-len", "48", "--global-batch", "4", "--lr",
         "0.01", "--seed", "5", "--bucket-mb", "1", "--block", "128",
         "--ckpt-dir", "d", "--ckpt-every", "3", "--resume",
         "--reload-every", "2", "--decode-backend", "paged"])
    assert (s.arch, s.smoke, s.steps, s.mesh.dp) == ("minitron_4b", True,
                                                     7, 2)
    assert (s.sync.bucket_bytes, s.sync.block) == (1 << 20, 128)
    assert s.data.seed == 5 and s.seed == 5
    assert (s.serve.reload_every, s.serve.decode_backend) == (2, "paged")
    f = tmp_path / "s.json"
    spec().save(f)
    over = tapi.RunSpec.from_args(["--spec", str(f), "--steps", "9"])
    assert over.steps == 9 and over.arch == "minitron_4b" and over.smoke
    j = japi.RunSpec.from_args(["--spec", str(f), "--steps", "9"])
    assert _json(j) == _json(over)


# ---------------------------------------------- exact resume on the CPU
RESUME_CASES = {
    "plain": {},
    "error-feedback": dict(sync=dict(error_feedback=True)),
    "sparse-residuals": dict(sync=dict(error_feedback=True,
                                       sparse_residuals=True)),
    "onn-bits-2": dict(sync=dict(bits=2, error_feedback=True,
                                 photonics=dict(fidelity="onn"))),
    # 2 pods of 2 peers: the residuals' 4 rows through the checkpoint
    "cascade-pods-2": dict(mesh=dict(pods=2),
                           sync=dict(mode="cascade", error_feedback=True)),
}


def _run(direc, steps, resume=False, **kw):
    s = spec(steps=steps, ckpt=dict(dir=str(direc), every=2, resume=resume),
             **kw)
    sess = tapi.TrainSession(s, callbacks=[tapi.PeriodicCheckpoint(2)],
                             device="cpu")
    recs = sess.run()
    return sess, recs


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_exact(case, tmp_path, monkeypatch):
    """6 steps uninterrupted against 4 steps, then a fresh session that
    resumes from the step-3 checkpoint: steps 4 and 5 give the same
    losses bit for bit, and the same state."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    kw = RESUME_CASES[case]
    full, _ = _run(tmp_path / "a", 6, **kw)
    _run(tmp_path / "b", 4, **kw)
    resumed, recs = _run(tmp_path / "b", 6, resume=True, **kw)
    assert [r["step"] for r in recs] == [4, 5]      # resumed, not restarted
    assert [resumed.losses[s] for s in (4, 5)] == [full.losses[s]
                                                   for s in (4, 5)]
    for got, want in ((resumed.params, full.params),
                      (resumed.opt_state, full.opt_state)):
        assert all(a.shape == b.shape and torch.equal(a, b)
                   for a, b in zip(leaves(got), leaves(want)))
    if "error_feedback" in json.dumps(kw):
        assert full.sync_state["rep"].shape[0] == full.peers
        assert full.sync_state["rep"].abs().max() > 0
        assert torch.equal(resumed.sync_state["rep"], full.sync_state["rep"])
    if "sparse" in case:
        from repro_torch.checkpoint import read_manifest
        sync = [p for p in read_manifest(tmp_path / "b", 3)["leaves"]
                if p.startswith("sync/")]
        assert sync and all(p.rsplit("/", 1)[-1] in ("idx", "val", "shape")
                            for p in sync)


def test_resume_refuses_a_mismatched_spec(tmp_path):
    _run(tmp_path, 2, sync=dict(error_feedback=True))
    bad = spec(steps=4, sync=dict(error_feedback=False),
               ckpt=dict(dir=str(tmp_path), resume=True))
    with pytest.raises(tapi.SpecMismatchError, match="error_feedback"):
        tapi.TrainSession(bad, callbacks=[], device="cpu")
    # compatible changes (lr, steps) resume fine
    ok = spec(steps=3, optim=dict(lr=5e-4), sync=dict(error_feedback=True),
              ckpt=dict(dir=str(tmp_path), resume=True))
    assert tapi.TrainSession(ok, callbacks=[], device="cpu").step == 2


def test_peer_count_change_needs_allow_reshard(tmp_path, capsys):
    """A checkpoint of 2 peers resumed with 4: refused without
    --allow-reshard; with it the params and optimizer are reloaded and the
    residuals (a row a peer) re-zeroed, with JAX's message."""
    ef = dict(sync=dict(error_feedback=True))
    sess, _ = _run(tmp_path, 2, **ef)
    four = dict(mesh=dict(dp=4), ckpt=dict(dir=str(tmp_path), resume=True),
                steps=3, **ef)
    with pytest.raises(tapi.SpecMismatchError, match="--allow-reshard"):
        tapi.TrainSession(spec(**four), callbacks=[], device="cpu")
    for sparse in (False, True):
        if sparse:
            _run(tmp_path / "sp", 2, sync=dict(error_feedback=True,
                                               sparse_residuals=True))
            four["ckpt"] = dict(dir=str(tmp_path / "sp"), resume=True)
        re = tapi.TrainSession(spec(**four, elastic=dict(allow_reshard=True)),
                               callbacks=[], device="cpu")
        out = capsys.readouterr().out
        assert "residuals re-zeroed" in out and "resharded (2, 1) -> (4, 1)" \
            in out
        assert re.step == 2 and re.sync_state["rep"].shape[0] == 4
        assert not re.sync_state["rep"].any()
        assert all(torch.equal(a, b) for a, b in zip(leaves(re.params),
                                                     leaves(sess.params)))
        assert int(re.opt_state["step"]) == 2


def test_cli_checkpoints_and_resumes_from_a_spec_file(tmp_path, capsys):
    """--spec on the CPU through the CLI: --ckpt-dir/--resume, the JSONL
    --log file, and the losses of an uninterrupted run."""
    f = tmp_path / "run.json"
    spec(sync=dict(error_feedback=True)).save(f)
    base = ["--device", "cpu", "--spec", str(f), "--ckpt-every", "2"]
    assert train.main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "a")]) == 0
    full = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    train.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    log = tmp_path / "m.jsonl"
    train.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                       "--resume", "--log", str(log)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 1"
    got = [json.loads(x) for x in out[1:]]
    assert [r["loss"] for r in got] == [r["loss"] for r in full[2:]]
    assert [json.loads(x) for x in log.read_text().splitlines()] == got
    assert latest_step(tmp_path / "b") == 3


# ---------------------------------------------- across the two packages
@pytest.fixture(scope="module")
def jax_four_steps(tmp_path_factory):
    """A JAX TrainSession (one device, error feedback) run 4 steps
    uninterrupted, checkpointing steps 1 and 3."""
    direc = tmp_path_factory.mktemp("jax_run")
    kw = dict(mesh=dict(dp=1), data=dict(global_batch=2),
              sync=dict(error_feedback=True),
              ckpt=dict(dir=str(direc), every=2))
    sess = japi.TrainSession(jspec(**kw),
                             callbacks=[japi.PeriodicCheckpoint(2)])
    recs = sess.run()
    return direc, kw, {r["step"]: r["loss"] for r in recs}


def test_port_resumes_a_jax_checkpoint(jax_four_steps, tmp_path):
    direc, kw, jloss = jax_four_steps
    shutil.copytree(direc / "step_1", tmp_path / "step_1")
    kw = {**kw, "ckpt": dict(dir=str(tmp_path), every=2, resume=True)}
    sess = tapi.TrainSession(spec(**kw), callbacks=[], device="cpu")
    assert sess.step == 2
    recs = sess.run()
    assert [r["step"] for r in recs] == [2, 3]
    assert abs(sess.losses[2] - jloss[2]) < CROSS_LOSS_TOL, (sess.losses,
                                                             jloss)


def test_jax_resumes_a_port_checkpoint(jax_four_steps, tmp_path):
    """The port writes steps 0-2 (checkpoint of step 1 copied aside); a
    JAX TrainSession resumes it, its run_spec validating, and its step 2
    loss is the port's within CROSS_LOSS_TOL."""
    _, kw, _ = jax_four_steps
    kw = {**kw, "ckpt": dict(dir=str(tmp_path / "a"), every=2)}
    port = tapi.TrainSession(spec(**{**kw, "steps": 3}),
                             callbacks=[tapi.PeriodicCheckpoint(2)],
                             device="cpu")
    port.run()
    shutil.copytree(tmp_path / "a" / "step_1", tmp_path / "b" / "step_1")
    kw["ckpt"] = dict(dir=str(tmp_path / "b"), every=2, resume=True)
    jsess = japi.TrainSession(jspec(**{**kw, "steps": 3}), callbacks=[])
    assert jsess.step == 2
    rec = jsess.run()[0]
    assert rec["step"] == 2
    assert abs(rec["loss"] - port.losses[2]) < CROSS_LOSS_TOL


# -------------------------------------------------------------- callbacks
def _feed(wd, times):
    records = []
    for t in times:
        rec = {"step": len(records), "time_s": t}
        wd.on_step_end(None, rec)
        records.append(rec)
    return records


@pytest.mark.parametrize("case", ["trip", "resets", "warmup", "disabled"])
def test_watchdog_cases_match_jax(case):
    """The four StragglerWatchdog cases of tests/test_callbacks.py, on
    the port's watchdog and JAX's alike."""
    from repro.api.callbacks import StragglerWatchdog as JaxWatchdog
    args, times, flagged = {
        "trip": ((3.0, 50, 3), [1.0] * 5 + [10.0], [5]),
        "resets": ((3.0, 50, 3), [1.0] * 5 + [10.0] + [1.0] * 5, [5]),
        "warmup": ((3.0, 50, 10), [1.0, 1.0, 50.0], []),
        "disabled": ((0.0, 50, 0), [1.0, 1.0, 1.0, 1000.0], []),
    }[case]
    for cls in (tcb.StragglerWatchdog, JaxWatchdog):
        wd = cls(*args)
        recs = _feed(wd, times)
        assert [i for i, r in enumerate(recs) if r.get("straggler")] \
            == flagged, cls
        assert wd.n_flagged == len(flagged)
        assert wd.enabled == (case != "disabled")
        if case == "disabled":
            assert wd.times == []


def test_periodic_checkpoint_sigterm_and_request_stop(tmp_path):
    """Checkpoints at every 3rd step and at the end; a SIGTERM in the
    middle of a run requests a stop, which checkpoints the step it ends
    on; the handlers are restored after."""
    s = spec(steps=8, ckpt=dict(dir=str(tmp_path), every=3, keep=10))
    saved = []

    class Spy(tapi.Callback):
        def on_checkpoint(self, session, step):
            saved.append(step)

        def on_step(self, session, record):
            if record["step"] == 3:
                signal.raise_signal(signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    sess = tapi.TrainSession(s, callbacks=[tcb.SigtermHandler(), Spy(),
                                           tcb.PeriodicCheckpoint(3)],
                             device="cpu")
    recs = sess.run()
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert sess.stop_requested and saved == [2, 3]
    assert signal.getsignal(signal.SIGTERM) is before
    assert latest_step(tmp_path) == 3
    # the rest of the run, to its end: every 3rd step and the last
    rest = tapi.TrainSession(dataclasses.replace(
        s, ckpt=dataclasses.replace(s.ckpt, resume=True)),
        callbacks=[Spy(), tcb.PeriodicCheckpoint(3)], device="cpu")
    saved.clear()
    assert [r["step"] for r in rest.run(n_steps=3)] == [4, 5, 6]
    assert saved == [5, 6]             # every 3rd, then the end of run()
    rest.run()
    assert saved == [5, 6, 7]
    assert sorted(int(p.name[5:]) for p in tmp_path.glob("step_*")) == \
        [2, 3, 5, 6, 7]


def test_sigterm_handler_installs_only_from_the_main_thread():
    import threading
    h = tcb.SigtermHandler()
    t = threading.Thread(target=h.on_train_start, args=(None,))
    t.start()
    t.join()
    assert h._previous == {}


def test_jsonl_logger_and_default_callbacks(tmp_path):
    out = io.StringIO()
    s = spec(log=str(tmp_path / "m.jsonl"), watchdog=0.0)
    cbs = tapi.default_callbacks(s, out=out)
    assert [type(c).__name__ for c in cbs] == [
        "StragglerWatchdog", "JsonlLogger", "PeriodicCheckpoint",
        "SigtermHandler"]
    recs = tapi.TrainSession(dataclasses.replace(s, steps=2), cbs,
                             device="cpu").run()
    assert [json.loads(x) for x in out.getvalue().splitlines()] == recs
    assert (tmp_path / "m.jsonl").read_text() == out.getvalue()


# --------------------------------------------------------------- schedule
def test_cosine_schedule_matches_jax():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    for warmup, total, ratio in ((10, 100, 0.1), (0, 20, 0.0), (5, 5, 0.5)):
        want = [float(jschedule.cosine_schedule(s, warmup, total, ratio))
                for s in steps]
        got = [cosine_schedule(s, warmup, total, ratio) for s in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        t = cosine_schedule(torch.tensor(steps), warmup, total, ratio)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7)


# -------------------------------------------------- build, exports, device
def test_wire_models_and_exports_match_jax():
    for kw in (tiny(), tiny(mesh=dict(dp=4), sync=dict(bits=4)),
               tiny(sync=dict(mode="psum"))):
        t, j = tapi.RunSpec.from_json_dict(kw), japi.RunSpec.from_json_dict(kw)
        assert tapi.modeled_bytes_on_wire(t) == japi.modeled_bytes_on_wire(j)
        for ov in (False, True):
            assert tapi.modeled_time_on_wire(t, overlap=ov) == \
                japi.modeled_time_on_wire(j, overlap=ov)
    for arch, smoke in (("minitron_4b", True), ("paper_llama", False)):
        t = tapi.RunSpec(arch=arch, smoke=smoke).model_config()
        j = japi.RunSpec(arch=arch, smoke=smoke).model_config()
        assert t.param_count() == j.param_count()
    for name in ("ElasticTrainSession", "Membership"):
        with pytest.raises(NotImplementedError, match="elastic membership"):
            getattr(tapi, name)
    with pytest.raises(NotImplementedError, match="sharding"):
        from repro_torch.api import param_specs  # noqa: F401
    assert set(tapi.__all__) <= set(dir(tapi))
    missing = set(japi.__all__) - set(tapi.__all__)
    assert missing == {"ElasticTrainSession", "Membership", "param_specs",
                       "sync_state_specs", "decode_cache_specs"}


def test_sessions_need_cuda_unless_a_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tapi.TrainSession, tapi.ServeSession):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(spec())
    with pytest.raises(tapi.SpecError, match="seq-sharded"):
        tapi.ServeSession(spec(), device="cpu", seq_shard_cache=True)
    # JAX's ServeSession decodes the MoE and enc-dec families over its
    # contiguous cache; the port serves both on it too (whisper with its
    # enc_frames)
    moe = tapi.ServeSession(tapi.RunSpec(arch="phi35_moe_42b", smoke=True),
                            device="cpu")
    assert moe.contiguous and moe.generate([[1, 2, 3]], 2).shape == (1, 2)
    whisper = tapi.ServeSession(tapi.RunSpec(arch="whisper_tiny",
                                             smoke=True), device="cpu")
    frames = torch.zeros((1, whisper.cfg.enc_frames, whisper.cfg.d_model))
    assert whisper.contiguous and whisper.generate(
        [[1, 2, 3]], 2, max_seq=whisper.cfg.enc_frames,
        enc_frames=frames).shape == (1, 2)


# ------------------------------------------------------- serving + reload
def _f32_pair(seed=0):
    """minitron smoke in f32: JAX params and the same weights here."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("minitron_4b"),
                               dtype="float32")
    jparams = jlm.init_params(jcfg, ShardCtx(), jax.random.PRNGKey(seed))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jparams, cfg, tlm.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def test_serve_session_generate_matches_jax():
    """Greedy tokens of ServeSession.generate (one prefill, the paged
    pool) against JAX's ServeSession (prefill, contiguous cache) on the
    same f32 weights.  JAX's contiguous cache holds the model dtype,
    bf16, so the port's pool is bf16 too: both round K/V to bf16 when
    they write the cache and attend in f32, and the tokens are equal."""
    jparams, cfg, params = _f32_pair()
    rng = np.random.default_rng(3)
    s = spec(serve=dict(page_size=4, kv_dtype="bf16"))
    sess = tapi.ServeSession(s, params=params, device="cpu", cfg=cfg)
    jsess = japi.ServeSession(jspec(mesh=dict(dp=1)), params=jparams)
    for b, t in ((3, 7), (2, 8), (1, 1)):
        prompts = rng.integers(0, cfg.vocab, (b, t))
        want = np.asarray(jsess.generate(prompts, gen_len=6, max_seq=24))
        got = sess.generate(prompts, gen_len=6, max_seq=24)
        assert got.shape == (b, 6)
        np.testing.assert_array_equal(got.numpy(), want)
    logits, cache = sess.prefill(rng.integers(0, cfg.vocab, (2, 5)))
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert cache["layers"]["k"].shape[:4] == (cfg.n_layers, 2,
                                              cfg.n_kv_heads, 5)
    eng = sess.engine()
    assert isinstance(eng, ServeEngine) and eng.params is sess.params


def test_serve_session_resolves_params_from_the_checkpoint(tmp_path):
    """The argument, then the checkpoint when ckpt.resume is set, then a
    seeded init; the checkpoint a TrainSession wrote serves as is."""
    tr = tapi.TrainSession(spec(steps=2, ckpt=dict(dir=str(tmp_path))),
                           device="cpu")
    tr.run()
    served = tapi.ServeSession(spec(ckpt=dict(dir=str(tmp_path),
                                              resume=True)), device="cpu")
    assert served.params_step == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(served.params),
                                                 leaves(tr.params)))
    fresh = tapi.ServeSession(spec(ckpt=dict(dir=str(tmp_path))),
                              device="cpu")
    assert fresh.params_step is None
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(fresh.params), leaves(tlm.init_params(fresh.cfg, 0, "cpu"))))


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(3, 11)),)).tolist()
            for _ in range(n)]


def test_hot_swap_picks_up_newer_checkpoint_mid_serve(tmp_path):
    """The mirror of tests/test_serving.py's hot swap: an engine with
    reload_every=1 serves while a newer checkpoint lands; the swap is
    seen, and a request admitted after it decodes with the new params
    (a fresh session's tokens)."""
    s = spec(serve=dict(page_size=4, max_seq=32, reload_every=1),
             ckpt=dict(dir=str(tmp_path), resume=True))
    cfg = s.model_config()
    p0 = tlm.init_params(cfg, 0, "cpu")
    save_checkpoint(tmp_path, 1, p0)
    eng = ServeEngine.from_spec(s, device="cpu")
    assert eng.params_step == 1 and eng.reloader is not None
    prompts = _prompts(2, cfg.vocab, seed=2)
    rid0 = eng.submit(prompts[0], 10)
    for _ in range(3):
        eng.step()
    p1 = tree_map(lambda a: (a.float() * 1.5).to(a.dtype), p0)
    save_checkpoint(tmp_path, 7, p1)
    rid1 = eng.submit(prompts[1], 6)
    while eng.has_work():
        eng.step()
    assert eng.params_step == 7
    assert len(eng.results[rid0]) == 10 and len(eng.results[rid1]) == 6
    ref = tapi.ServeSession(s, params=p1, device="cpu").generate(
        np.asarray([prompts[1]]), gen_len=6, max_seq=32)[0]
    assert eng.results[rid1] == ref.tolist()
    # without reload_every the engine never polls
    quiet = ServeEngine.from_spec(dataclasses.replace(
        s, serve=dataclasses.replace(s.serve, reload_every=0)), device="cpu")
    assert quiet.reloader is None and quiet.params_step == 7


def test_reloader_stat_guard_skips_idle_listings(tmp_path, monkeypatch):
    """Idle polls cost one os.stat: latest_step only runs when the
    checkpoint directory's mtime moved, and a checkpoint landing after
    the guard armed is still picked up."""
    s = spec(serve=dict(reload_every=1),
             ckpt=dict(dir=str(tmp_path), resume=True))
    cfg = s.model_config()
    p0 = tlm.init_params(cfg, 0, "cpu")
    r = treload.ParamReloader(s, cfg, "cpu")
    assert r.poll() is None                    # nothing written yet
    save_checkpoint(tmp_path, 1, p0)
    calls = {"n": 0}
    real = treload.latest_step

    def counting(d):
        calls["n"] += 1
        return real(d)

    monkeypatch.setattr(treload, "latest_step", counting)
    got = r.poll()
    assert got is not None and got[1] == 1
    n_loaded = calls["n"]
    for _ in range(5):
        assert r.poll() is None
    assert calls["n"] == n_loaded
    save_checkpoint(tmp_path, 3, p0)
    got = r.poll()
    assert got is not None and got[1] == 3
    assert calls["n"] == n_loaded + 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(got[0]),
                                                 leaves(p0)))
