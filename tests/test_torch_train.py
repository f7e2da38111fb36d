"""The port's training path on the CPU, held against the JAX package on
the same weights (carried across with ``params_from_jax``) and the same
tokens: ``loss_fn`` and its gradients, ``SyntheticLM``, AdamW, and the
trainer over stacked peers against ``make_train_step`` on a 1-device
mesh.

XLA and PyTorch sum matmuls, softmaxes and reductions in other orders,
so nothing downstream of a float gradient is held bit for bit: losses
and gradients are held to stated f32 tolerances.  (The sync itself is
held bit-exact on identical input buckets in test_torch_collectives.)
"""
import argparse
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jax_configs
from repro.api import MeshSpec
from repro.collectives import SyncConfig as JaxSyncConfig
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.optim import adamw as jadamw
from repro.photonics import PhotonicsConfig as JaxPhotonicsConfig
from repro_torch.collectives.engine import SyncConfig
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.photonics import PhotonicsConfig, runtime
from repro_torch.tree import leaves, leaves_with_paths

# f32 loss of a 2-3 layer model: the two frameworks reorder sums, a few
# ulp per op; the loss is O(5)
LOSS_TOL = 2e-5
# gradients: the same reorderings, compared relative to each leaf's
# largest entry (embedding rows that no token hits are exactly zero)
GRAD_RTOL = 1e-4
# five trainer steps in f32 with the same tokens: per-step differences of
# ~1e-6 grow through AdamW's normalisation; an optinc code may flip where
# a gradient sits within an ulp of a rounding edge
TRAIN_TOL = 2e-4

NARROW = dict(name="paper-llama-narrow", family="dense", n_layers=2,
              d_model=128, n_heads=8, n_kv_heads=8, d_ff=512, vocab=512,
              dtype="float32")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfg_pair(which: str):
    """(JAX config, port config), the same fields, f32."""
    if which == "narrow":
        return JaxModelConfig(**NARROW), ModelConfig(**NARROW)
    jcfg = dataclasses.replace(jax_configs.get_smoke("minitron_4b"),
                               dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _port_params(jparams, cfg):
    return tlm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("which", ["narrow", "minitron"])
def test_loss_and_gradients_match_jax(which):
    jcfg, cfg = cfg_pair(which)
    jparams = jlm.init_params(jcfg, jl.ShardCtx(), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (3, 41)).astype(np.int32)

    mesh = MeshSpec().build()
    ctx = jsteps.make_ctx(mesh)
    specs = jlm.flat_specs(jcfg, ctx)

    def f(params, toks):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(jcfg, ctx, p, {"tokens": toks}),
            has_aux=True)(params)
        return loss, grads

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, P()),
                               out_specs=(P(), specs), check_vma=False))
    with jax.set_mesh(mesh):
        jloss, jgrads = fn(jparams, jnp.asarray(tokens))

    params = _port_params(jparams, cfg)
    train_leaves = [p.requires_grad_() for _, p in leaves_with_paths(params)]
    loss, aux = tlm.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, train_leaves)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    assert torch.equal(aux["nll"], loss)      # dense: no aux loss
    for (path, _), g in zip(leaves_with_paths(params), grads):
        want = np.asarray(jgrads[path[0]] if len(path) == 1
                          else jgrads[path[0]][path[1]])
        scale = np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))


# ---------------------------------------------------------------- data
def test_synthetic_lm_tokens_are_the_jax_tokens():
    for kw in (dict(vocab=512, seq_len=16, global_batch=4, seed=3),
               dict(vocab=32000, seq_len=64, global_batch=8, seed=0)):
        for shard, shards in ((0, 1), (1, 2)):
            port = tdata.SyntheticLM(tdata.DataConfig(**kw), shard, shards)
            ref = jdata.SyntheticLM(jdata.DataConfig(**kw), shard, shards)
            for step in (0, 5):
                np.testing.assert_array_equal(port.batch(step),
                                              ref.batch(step))
    it = tdata.make_batch_iterator(tdata.DataConfig(vocab=64, seq_len=4,
                                                    global_batch=2), 7)
    step, batch = next(it)
    assert step == 7 and batch["tokens"].shape == (2, 5)
    with pytest.raises(ValueError, match="divisible"):
        tdata.SyntheticLM(tdata.DataConfig(global_batch=3), 0, 2)


# ---------------------------------------------------------------- adamw
def test_adamw_and_clip_match_jax():
    """Two AdamW steps on f32 and bf16 leaves (matrices decay, vectors do
    not), clipped by the global norm first.  Same f32 operations in the
    same order; XLA may fuse a multiply-add, so within 1e-7 in f32, and
    within one bf16 ulp (2^-9 at |p| < 0.5) where that can flip a bf16
    rounding."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "e": {"m": (3, 4, 2)}}
    cfg = tadamw.AdamWConfig(lr=1e-2, clip_norm=0.5)
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=0.5)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        def draw(scale):
            return {"w": rng.normal(size=shapes["w"]) * scale,
                    "b": rng.normal(size=shapes["b"]) * scale,
                    "e": {"m": rng.normal(size=shapes["e"]["m"]) * scale}}
        p_np = draw(0.1)
        tp = jax.tree.map(lambda a: torch.tensor(a, dtype=torch.float32)
                          .to(dtype), p_np)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(
            jdtype), p_np)
        tstate, jstate = tadamw.adamw_init(cfg, tp), jadamw.adamw_init(jcfg,
                                                                       jp)
        for _ in range(2):
            g_np = draw(1.0)
            tg = jax.tree.map(lambda a: torch.tensor(a, dtype=torch.float32)
                              .to(dtype), g_np)
            jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(
                jdtype), g_np)
            tg, tnorm = tadamw.clip_by_global_norm(tg, cfg.clip_norm)
            jg, jnorm = jadamw.clip_by_global_norm(jg, jcfg.clip_norm)
            assert abs(tnorm.item() - float(jnorm)) <= 1e-6 * float(jnorm)
            tp, tstate = tadamw.adamw_update(cfg, tp, tg, tstate)
            jp, jstate = jadamw.adamw_update(jcfg, jp, jg, jstate)
        assert int(tstate["step"]) == int(jstate["step"]) == 2
        for got, want in ((tp, jp), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            for (path, t), j in zip(leaves_with_paths(got),
                                    jax.tree.leaves(want)):
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(j, np.float32), rtol=0,
                    atol=1e-7 if dtype == torch.float32 else 2 ** -9,
                    err_msg=f"{dtype} {path}")


# -------------------------------------------------------------- trainer
def _opts(*argv):
    return train.parse_args(["--device", "cpu", *argv])


@pytest.mark.parametrize("mode", ["psum", "optinc"])
def test_trainer_matches_jax_make_train_step(mode):
    """The port's trainer at --mesh 1x1 against JAX's make_train_step on
    a 1-device mesh, 5 steps, same weights and tokens (f32 minitron smoke:
    GQA; 0.25 MiB buckets, so three buckets with a ragged tail)."""
    jcfg, cfg = cfg_pair("minitron")
    jparams = jlm.init_params(jcfg, jl.ShardCtx(), jax.random.PRNGKey(0))
    argv = ["--sync", mode, "--mesh", "1x1", "--steps", "5", "--lr", "1e-3",
            "--global-batch", "4", "--seq-len", "32", "--bucket-mb", "0.25",
            "--block", "128", "--error-feedback"]
    out = io.StringIO()
    recs = train.run(_opts(*argv), params=_port_params(jparams, cfg),
                     cfg=cfg, out=out)
    assert [json.loads(line) for line in out.getvalue().splitlines()] == recs
    assert [r["step"] for r in recs] == list(range(5))

    mesh = MeshSpec().build()
    sync = JaxSyncConfig(mode=mode, axes=("data",), bits=8, block=128,
                         error_feedback=True, bucket_bytes=2 ** 18)
    opt = jadamw.AdamWConfig(lr=1e-3)
    fn, _, _ = jsteps.make_train_step(jcfg, mesh, sync, opt)
    fn = jax.jit(fn)
    params, ostate = jparams, jadamw.adamw_init(opt, jparams)
    sstate = jsteps.init_sync_state(jcfg, mesh, sync)
    data = jdata.SyntheticLM(jdata.DataConfig(vocab=jcfg.vocab, seq_len=32,
                                              global_batch=4, seed=0))
    want = []
    with jax.set_mesh(mesh):
        for step in range(5):
            params, ostate, sstate, metrics = fn(
                params, ostate, sstate,
                {"tokens": jnp.asarray(data.batch(step))},
                jax.random.PRNGKey(step))
            want.append(float(metrics["loss"]))
    got = [r["loss"] for r in recs]
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_TOL)
    assert got[-1] < got[0]


def test_loss_falls_with_two_stacked_peers_and_optinc(capsys):
    assert train.main(["--device", "cpu", "--arch", "minitron_4b",
                       "--smoke-config", "--sync", "optinc", "--mesh", "2x1",
                       "--steps", "20", "--global-batch", "4", "--seq-len",
                       "32", "--lr", "1e-3"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in recs] == list(range(20))
    # the straggler watchdog may mark a slow step, as in the JAX CLI
    assert all(set(r) - {"straggler"} == {"step", "loss", "time_s"}
               for r in recs)
    first = sum(r["loss"] for r in recs[:5]) / 5
    last = sum(r["loss"] for r in recs[-5:]) / 5
    assert last < first - 0.3, (first, last)


def test_train_needs_cuda_unless_a_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke-config", "--steps", "1"])


@pytest.mark.parametrize("argv,what", [
    # taken since the checkpoint slice (what = a check of the spec)
    pytest.param(["--ckpt-dir", "x"], lambda s: s.ckpt.dir == "x",
                 id="argv0-checkpointing"),
    # taken since the ring/cascade slice
    pytest.param(["--overlap"], lambda s: s.sync.overlap,
                 id="argv1-overlap"),
    # taken since the mesh fidelity was ported
    pytest.param(["--fidelity", "mesh", "--bits", "2"],
                 lambda s: (s.sync.photonics.fidelity, s.sync.bits)
                 == ("mesh", 2), id="argv2-fidelities"),
    # tp > 1 is taken since FSDP/TP were ported, as processes only: the
    # stacked CLI names the launcher
    pytest.param(["--mesh", "2x2"], "torch.distributed.run",
                 id="argv3-tensor parallelism"),
    pytest.param(["--sync", "cascade"],
                 lambda s: (s.sync.mode, s.mesh.pods,
                            s.resolved_sync().axes)
                 == ("cascade", 2, ("pod", "data")), id="argv4-cascade"),
    pytest.param(["--sync", "ring"], lambda s: s.sync.mode == "ring",
                 id="argv5-ring"),
    pytest.param(["--ckpt-dir", "x", "--ckpt-every", "3", "--ckpt-keep",
                  "2", "--resume"],
                 lambda s: (s.ckpt.dir, s.ckpt.every, s.ckpt.keep,
                            s.ckpt.resume) == ("x", 3, 2, True),
                 id="ckpt-every-keep-resume"),
    pytest.param(["--error-feedback", "--sparse-residuals"],
                 lambda s: s.sync.sparse_residuals and s.sync.error_feedback,
                 id="sparse-residuals"),
    pytest.param(["--log", "m.jsonl", "--watchdog", "2.5"],
                 lambda s: (s.log, s.watchdog) == ("m.jsonl", 2.5),
                 id="log-watchdog"),
    pytest.param(["--allow-reshard"], lambda s: s.elastic.allow_reshard,
                 id="allow-reshard"),
    pytest.param(["--sparse-residuals"], "needs --error-feedback",
                 id="sparse-residuals-alone"),
    pytest.param(["--pods", "2"], lambda s: s.mesh.peers == 2
                 and s.resolved_sync().axes == ("pod", "data"), id="pods"),
    pytest.param(["--fsdp"], lambda s: s.mesh.ctx().fsdp, id="fsdp"),
    pytest.param(["--error-layers", "3,4,5,6"],
                 lambda s: s.sync.error_layers == (3, 4, 5, 6),
                 id="error-layers"),
    pytest.param(["--elastic"], "elastic membership", id="elastic"),
    pytest.param(["--evict-after", "2"], "elastic membership",
                 id="evict-after"),
    pytest.param(["--heartbeat-s", "2"], "elastic membership",
                 id="heartbeat-s"),
    pytest.param(["--members-dir", "m"], "elastic membership",
                 id="members-dir"),
    pytest.param(["--seq-parallel"], "sequence parallelism",
                 id="seq-parallel"),
    pytest.param(["--remat-groups", "2"],
                 lambda s: s.mesh.ctx().remat_groups == 2,
                 id="remat-groups"),
])
def test_train_names_what_is_not_ported(argv, what, capsys):
    if callable(what):
        assert what(train.parse_args(["--steps", "1", *argv]).spec)
        return
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--steps", "1", *argv])
    assert what in str(e.value)


@pytest.mark.parametrize("flag", ["--mesh-backend", "--blk-b",
                                  "--theta-drift-std", "--shot-noise-std"])
def test_train_names_the_mesh_slice_for_its_flags(flag, capsys):
    """The mesh fidelity's flags: --mesh-backend, --blk-b and the
    PhaseNoise stds are taken with --fidelity mesh (and, as in JAX,
    refused without it); a noisy run trains on the CPU, its losses a
    function of --seed."""
    value = {"--mesh-backend": "pallas", "--blk-b": "64"}.get(flag, "0.01")
    argv = ["--steps", "1", "--fidelity", "mesh", flag, value]
    ph = train.sync_config(_opts(*argv)).photonics
    field = flag[2:].replace("-", "_")
    assert getattr(ph, field) == type(getattr(ph, field))(value)
    assert (ph.mesh_backend, ph.blk_b) == (
        "pallas" if flag == "--mesh-backend" else "xla",
        64 if flag == "--blk-b" else 0)
    with pytest.raises(SystemExit):
        _opts("--fidelity", "onn", flag, value)
    if flag in ("--theta-drift-std", "--shot-noise-std"):
        runs = []
        for seed in ("0", "0", "1"):
            assert train.main(["--device", "cpu", "--arch", "minitron_4b",
                               "--smoke-config", "--bits", "2", "--mesh",
                               "2x1", "--global-batch", "4", "--seq-len",
                               "16", "--steps", "2", "--seed", seed,
                               "--fidelity", "mesh", flag, "0.3"]) == 0
            runs.append([json.loads(line)["loss"] for line in
                         capsys.readouterr().out.splitlines()])
        assert runs[0] == runs[1] and all(map(np.isfinite, runs[2]))


def test_train_takes_fidelity_onn_and_refuses_what_jax_refuses(
        monkeypatch):
    def fidelity(argv):
        return train.parse_args(argv).spec.sync.photonics.fidelity

    assert fidelity(["--fidelity", "onn"]) == "onn"
    assert fidelity([]) == "behavioral"
    with pytest.raises(SystemExit):
        train.parse_args(["--fidelity", "optical"])
    with pytest.raises(SystemExit, match="photonic-backend knob"):
        train.main(["--device", "cpu", "--steps", "1", "--fidelity", "onn",
                    "--sync", "psum"])
    # no trained ONN for bits 8: JAX's guidance, before the step loop
    monkeypatch.setattr(runtime, "_CACHE", {})
    monkeypatch.setattr(runtime, "RESULTS_PICKLES",
                        ("results/_absent_for_test.pkl",))
    with pytest.raises(SystemExit, match="no trained params.*--bits 2"):
        train.main(["--device", "cpu", "--steps", "1", "--fidelity", "onn",
                    "--bits", "8"])


def test_trainer_at_fidelity_onn_bits_2_is_behavioral_and_matches_jax(
        monkeypatch):
    """Bits 2 resolves the exact identity ONN: two stacked peers train to
    byte-identical losses and parameters at fidelities onn, mesh and
    behavioral; one peer through the CLI matches JAX make_train_step at
    fidelities onn and mesh (pallas executor) within TRAIN_TOL (narrow
    f32 model, error feedback on, 0.25 MiB buckets)."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    jcfg, cfg = cfg_pair("narrow")
    jparams = jlm.init_params(jcfg, jl.ShardCtx(), jax.random.PRNGKey(1))
    opt = tadamw.AdamWConfig(lr=1e-3)
    data = tdata.SyntheticLM(tdata.DataConfig(vocab=cfg.vocab, seq_len=32,
                                              global_batch=4, seed=0))
    runs = {}
    for fidelity in ("behavioral", "onn", "mesh"):
        sync = SyncConfig(mode="optinc", bits=2, block=128,
                          error_feedback=True, bucket_bytes=2 ** 18,
                          photonics=PhotonicsConfig(fidelity=fidelity))
        step = tsteps.make_train_step(cfg, 2, sync, opt, "cpu")
        params = _port_params(jparams, cfg)
        ostate = tadamw.adamw_init(opt, params)
        sstate = tsteps.init_sync_state(cfg, 2, sync, "cpu")
        losses = []
        for i in range(4):
            params, ostate, sstate, m = step(
                params, ostate, sstate, torch.from_numpy(data.batch(i)))
            losses.append(m["loss"].item())
        runs[fidelity] = losses, params
    for fidelity in ("onn", "mesh"):
        assert runs[fidelity][0] == runs["behavioral"][0]
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(runs[fidelity][1]), leaves(runs["behavioral"][1])))

    for fidelity, backend in (("onn", "xla"), ("mesh", "pallas")):
        argv = ["--sync", "optinc", "--bits", "2", "--fidelity", fidelity,
                "--mesh", "1x1", "--steps", "4", "--lr", "1e-3",
                "--global-batch", "4", "--seq-len", "32", "--bucket-mb",
                "0.25", "--block", "128", "--error-feedback"]
        if fidelity == "mesh":
            argv += ["--mesh-backend", backend]
        recs = train.run(_opts(*argv), params=_port_params(jparams, cfg),
                         cfg=cfg, out=io.StringIO())
        mesh = MeshSpec().build()
        jsync = JaxSyncConfig(mode="optinc", axes=("data",), bits=2,
                              block=128, error_feedback=True,
                              bucket_bytes=2 ** 18,
                              photonics=JaxPhotonicsConfig(
                                  fidelity=fidelity, mesh_backend=backend))
        jopt = jadamw.AdamWConfig(lr=1e-3)
        fn, _, _ = jsteps.make_train_step(jcfg, mesh, jsync, jopt)
        fn = jax.jit(fn)
        params, ostate = jparams, jadamw.adamw_init(jopt, jparams)
        sstate = jsteps.init_sync_state(jcfg, mesh, jsync)
        want = []
        with jax.set_mesh(mesh):
            for i in range(4):
                params, ostate, sstate, metrics = fn(
                    params, ostate, sstate,
                    {"tokens": jnp.asarray(data.batch(i))},
                    jax.random.PRNGKey(i))
                want.append(float(metrics["loss"]))
        np.testing.assert_allclose([r["loss"] for r in recs], want, rtol=0,
                                   atol=TRAIN_TOL)


def test_parse_args_takes_the_jax_flag_names():
    opts = train.parse_args(["--arch", "paper_llama", "--sync", "optinc",
                             "--bits", "8", "--block", "2048", "--mesh",
                             "4x1", "--global-batch", "32", "--seq-len",
                             "512", "--steps", "30", "--bucket-mb", "4",
                             "--error-feedback", "--lr", "3e-4", "--seed",
                             "1", "--smoke-config", "--fidelity", "onn"])
    assert isinstance(opts, argparse.Namespace) and opts.spec.mesh.dp == 4
    sync = opts.spec.sync
    assert (sync.photonics.fidelity, sync.bits, sync.block,
            sync.bucket_bytes, sync.error_feedback) == ("onn", 8, 2048,
                                                        4 << 20, True)
    assert (opts.spec.data.global_batch, opts.spec.data.seq_len,
            opts.spec.steps, opts.spec.seed, opts.spec.data.seed,
            opts.spec.optim.lr, opts.spec.smoke) == (32, 512, 30, 1, 1,
                                                     3e-4, True)
    ph = train.parse_args(["--fidelity", "mesh", "--mesh-backend",
                           "pallas", "--blk-b", "32"]).spec.sync.photonics
    assert (ph.fidelity, ph.mesh_backend, ph.blk_b) == ("mesh", "pallas", 32)
    defaults = train.parse_args([])
    assert defaults.device is None
    assert (defaults.spec.sync.photonics.mesh_backend,
            defaults.spec.sync.photonics.blk_b) == ("xla", 0)
    with pytest.raises(SystemExit):
        train.parse_args(["--global-batch", "6", "--mesh", "4x1"])
