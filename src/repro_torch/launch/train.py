"""Training entry point of the port (counterpart of
``repro.launch.train`` and the loop of ``repro.api.TrainSession``):
data-parallel training over N peers stacked on one card, gradients
averaged by the OptINC collective (or psum).

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --bits 8 --block 2048 --mesh 4x1 --global-batch 32 \\
      --seq-len 512 --steps 30

  # the gradient average through the in-network ONN (--bits 2: the
  # built-in exact identity ONN; wider widths need trained parameters,
  # see photonics.runtime)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --bits 2 --fidelity onn --mesh 4x1 --global-batch 32 \\
      --seq-len 512 --steps 10

  # ... through the ONN's phase-programmed MZI meshes (every mesh one
  # launch of the mesh_scan kernel; --mesh-backend xla and pallas both
  # run it, --blk-b is its row tile)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --bits 2 --fidelity mesh --mesh-backend pallas \\
      --mesh 4x1 --global-batch 32 --seq-len 512 --steps 10

  # thermal drift and shot noise on the emulated mesh (the PhaseNoise
  # model; --mesh-backend pallas draws the drift in the mesh_scan kernel,
  # xla perturbs the programmed coefficients before it; the bits-2 exact
  # identity has no rotation, so there only the shot noise acts)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --bits 2 --fidelity mesh --mesh-backend pallas \\
      --theta-drift-std 0.02 --shot-noise-std 0.01 --mesh 4x1 \\
      --global-batch 32 --seq-len 512 --steps 10

  # a CPU smoke run (the plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --smoke-config --sync optinc --mesh 2x1 --global-batch 4 \\
      --seq-len 32 --steps 3 --device cpu

Each step prints one JSON line ``{"step", "loss", "time_s"}`` like the
JAX CLI.  It takes the JAX flag names it supports; any other JAX flag
exits with an error naming the piece that is not ported yet.  The run
is on CUDA unless ``--device`` says otherwise, and raises when there is
no CUDA device.  Parameters are seeded from ``--seed`` with a
``torch.Generator`` (not ``jax.random``): ``run(opts, params=...)``
takes parameters carried across from JAX instead.  Step i's sync key is
``prng.fold_in(prng.PRNGKey(seed + 1), i)``, the JAX session's key tree.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import configs, prng
from ..collectives.bucketizer import DEFAULT_BUCKET_BYTES
from ..collectives.engine import SyncConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import lm
from ..optim.adamw import AdamWConfig, adamw_init
from ..photonics import runtime
from ..photonics.config import FIDELITIES, MESH_BACKENDS, PhotonicsConfig
from .steps import init_sync_state, make_train_step

# flags of the JAX CLI this port does not take yet, and what they need
_NOT_PORTED = {
    "--spec": "the RunSpec surface (repro.api)",
    "--pods": "the cascade backend and its pod axis",
    "--overlap": "streaming overlap",
    "--error-layers": "Table-II error injection",
    "--sparse-residuals": "checkpointing (checkpoint/ckpt.py)",
    "--fsdp": "FSDP",
    "--seq-parallel": "tensor/sequence parallelism",
    "--remat-groups": "rematerialization groups",
    "--ckpt-dir": "checkpointing (checkpoint/ckpt.py)",
    "--ckpt-every": "checkpointing (checkpoint/ckpt.py)",
    "--ckpt-keep": "checkpointing (checkpoint/ckpt.py)",
    "--resume": "checkpoint resume (checkpoint/ckpt.py)",
    "--elastic": "elastic membership (repro.elastic)",
    "--heartbeat-s": "elastic membership (repro.elastic)",
    "--allow-reshard": "elastic membership (repro.elastic)",
    "--members-dir": "elastic membership (repro.elastic)",
    "--evict-after": "elastic membership (repro.elastic)",
    "--watchdog": "the callbacks (repro.api.callbacks)",
    "--log": "the callbacks (repro.api.callbacks)",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="paper_llama")
    ap.add_argument("--smoke-config", action="store_true",
                    help="the arch's reduced SMOKE config")
    ap.add_argument("--sync", default="optinc",
                    help="psum | optinc (ring, cascade: not ported)")
    ap.add_argument("--bits", type=int, default=8, help="OptINC bit width B")
    ap.add_argument("--block", type=int, default=2048,
                    help="quantization block (0 = one scale per bucket)")
    ap.add_argument("--bucket-mb", type=float,
                    default=DEFAULT_BUCKET_BYTES / 2 ** 20)
    ap.add_argument("--fidelity", choices=FIDELITIES, default="behavioral",
                    help="optinc emulation depth: behavioral Q(mean) | "
                         "trained dense ONN | MZI mesh emulator")
    ap.add_argument("--mesh-backend", choices=MESH_BACKENDS, default="xla",
                    help="fidelity=mesh executor; both run the mesh_scan "
                         "kernel in the port")
    ap.add_argument("--blk-b", type=int, default=0,
                    help="mesh_scan kernel row tile (multiple of 8; 0 = "
                         "default)")
    ap.add_argument("--theta-drift-std", type=float, default=0.0,
                    help="PhaseNoise: thermal drift std (rad) on every "
                         "programmed MZI phase (fidelity=mesh)")
    ap.add_argument("--shot-noise-std", type=float, default=0.0,
                    help="PhaseNoise: additive noise std on the mesh's "
                         "analog outputs (fidelity=mesh)")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DPxTP: DP peers stacked on one card; TP must be 1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    opts, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED:
            raise SystemExit(f"error: {flag} needs {_NOT_PORTED[flag]}, "
                             f"which is not ported yet")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    try:
        dp, tp = (int(x) for x in opts.mesh.split("x"))
    except ValueError:
        ap.error(f"--mesh must be DPxTP (e.g. 4x1): {opts.mesh!r}")
    if tp != 1:
        raise SystemExit(f"error: --mesh {opts.mesh}: tensor parallelism "
                         f"(tp > 1) is not ported yet")
    if dp < 1 or opts.global_batch % dp:
        ap.error(f"global batch {opts.global_batch} must split over {dp} "
                 f"peers")
    for flag, set_ in (("--mesh-backend", opts.mesh_backend != "xla"),
                       ("--blk-b", opts.blk_b != 0),
                       ("--theta-drift-std", opts.theta_drift_std != 0.0),
                       ("--shot-noise-std", opts.shot_noise_std != 0.0)):
        if set_ and opts.fidelity != "mesh":
            ap.error(f"{flag} only applies to --fidelity mesh; got "
                     f"--fidelity {opts.fidelity}")
    opts.peers = dp
    return opts


def sync_config(opts: argparse.Namespace) -> SyncConfig:
    """The SyncConfig of parsed options (raises on what it refuses)."""
    return SyncConfig(mode=opts.sync, bits=opts.bits, block=opts.block,
                      error_feedback=opts.error_feedback,
                      bucket_bytes=int(opts.bucket_mb * 2 ** 20),
                      photonics=PhotonicsConfig(
                          fidelity=opts.fidelity,
                          mesh_backend=opts.mesh_backend,
                          blk_b=opts.blk_b,
                          theta_drift_std=opts.theta_drift_std,
                          shot_noise_std=opts.shot_noise_std))


def _device(name) -> torch.device:
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch.launch.train runs on CUDA by default and no "
                "CUDA device is available; pass --device cpu to train on "
                "the CPU")
        name = "cuda"
    return torch.device(name)


def run(opts: argparse.Namespace, params=None, cfg=None, out=None) -> list:
    """Train for ``opts.steps`` steps; prints and returns one record per
    step.  ``params`` (on the run's device) replaces the seeded init and
    ``cfg`` the model config of ``--arch`` (tests train an f32 copy)."""
    device = _device(opts.device)
    out = sys.stdout if out is None else out
    try:
        if cfg is None:
            cfg = (configs.get_smoke(opts.arch) if opts.smoke_config
                   else configs.get(opts.arch))
        sync = sync_config(opts)
        # resolve the in-network ONN before the first step, so a missing
        # one fails here with guidance (and, at fidelity mesh, program
        # its meshes), and put what it applies on the device
        runtime.warmup(sync, opts.peers, device)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}")
    opt = AdamWConfig(lr=opts.lr)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=opts.seq_len,
                                  global_batch=opts.global_batch,
                                  seed=opts.seed))
    if params is None:
        params = lm.init_params(cfg, opts.seed, device)
    opt_state = adamw_init(opt, params)
    sync_state = init_sync_state(cfg, opts.peers, sync, device)
    step_fn = make_train_step(cfg, opts.peers, sync, opt, device)
    # per-step keys are folded from a base key, as the JAX session folds
    # them, so step i sees the same key in any run
    base_key = prng.PRNGKey(opts.seed + 1)
    history = []
    for step in range(opts.steps):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(data.batch(step)).to(device)
        params, opt_state, sync_state, metrics = step_fn(
            params, opt_state, sync_state, tokens,
            prng.fold_in(base_key, step))
        loss = float(metrics["loss"])          # waits for the device
        record = {"step": step, "loss": round(loss, 5),
                  "time_s": round(time.perf_counter() - t0, 6)}
        print(json.dumps(record), file=out, flush=True)
        history.append(record)
    return history


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
