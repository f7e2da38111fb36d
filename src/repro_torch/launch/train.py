"""Training entry point of the port (counterpart of
``repro.launch.train``), a thin client of ``repro_torch.api``:
data-parallel training over N peers stacked on one card (or N
processes, one a card), gradients averaged by the OptINC collective,
its two-level cascade, a ring all-reduce or psum.

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

  # the paper's baseline, a ring all-reduce; the two-level carry cascade
  # over 2 pods of 2 peers (--pods 0 or absent: 2 for cascade), through
  # the behavioral Q(mean) or (bits 2) the emulated fabric; 4 pods of 4
  # peers is the paper's 16-server scenario
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync ring --mesh 4x1 --global-batch 32 --seq-len 512 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync cascade --pods 2 --mesh 2x1 --bits 8 --global-batch 32 \\
      --seq-len 512 --steps 10 [--bits 2 --fidelity onn|mesh]

  # Table II error injection into the averaged codes (the Fig. 7a
  # method), and streaming overlap of the sync with the backward
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --mesh 4x1 --error-layers 3,4,5,6 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --mesh 4x1 --overlap --error-feedback --steps 10

  # checkpoint every 5 steps (params, AdamW state and the error-feedback
  # residuals, in the JAX package's format), stop, and resume exactly
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --mesh 4x1 --error-feedback --steps 10 \\
      --ckpt-dir results/ckpt/paper_llama --ckpt-every 5 [--resume]

  # peers as processes, one per card: 4 ranks of one peer each, the
  # sync over NCCL (the codes reduce-scattered in 16-bit lanes, the
  # averaged codes all-gathered as uint8, the ring's ppermute rounds);
  # rank 0 prints the step lines and, at the end, a line of what each
  # rank sent and launched.  --device cpu runs gloo ranks on the CPU
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch paper_llama \\
      --sync optinc --bits 8 --mesh 4x1 --error-feedback \\
      --global-batch 32 --seq-len 512 --steps 10  # or --sync ring, ...

  # FSDP, tensor parallelism and remat groups over a (pod, data, model)
  # mesh of processes: 2 data peers x 2 model shards, the weights sharded
  # over 'data' too, groups of layers rematerialized (tp > 1 needs
  # torchrun; --fsdp and --remat-groups also run stacked)
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch deepseek_coder_33b --mesh 2x2 --fsdp --remat-groups 2 \\
      --sync optinc --bits 8 --global-batch 2 --seq-len 4096 --lr 1e-5

  # a whole scenario from a RunSpec JSON file (flags override it)
  PYTHONPATH=src python -m repro_torch.launch.train --spec my_run.json

  # a CPU smoke run (the plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_llama \\
      --smoke-config --sync optinc --mesh 2x1 --global-batch 4 \\
      --seq-len 32 --steps 3 --device cpu

Every flag is a RunSpec field override (``RunSpec.add_args``, the JAX
flag names, plus ``--block`` for ``sync.block``), and ``--device`` (cuda
by default, or cpu) is the one flag of the port alone; the run itself
is ``repro_torch.api.TrainSession``.  Each step prints one JSON line
``{"step", "loss", "time_s"}`` like the JAX CLI.  A JAX flag the port
does not run yet exits with an error naming the piece that is not
ported.  The run raises when there is no CUDA device and no --device.
Under ``torch.distributed.run`` (WORLD_SIZE, RANK and LOCAL_RANK set)
each process is one device of the ``pods * dp * tp`` mesh
(``api.session``), on its own card; the world must be that size.  Parameters are seeded from
``--seed`` with a ``torch.Generator`` (not
``jax.random``): ``run(opts, params=...)`` takes parameters carried
across from JAX instead.  Step i's sync key is
``prng.fold_in(prng.PRNGKey(seed + 1), i)``, the JAX session's key tree.
"""
from __future__ import annotations

import argparse
import sys

from ..api import RunSpec, SpecError, TrainSession, default_callbacks
from . import distributed


def parse_args(argv=None) -> argparse.Namespace:
    """Namespace(spec=<validated RunSpec>, device=<name or None>); a JAX
    flag the port does not run yet exits naming it (``RunSpec.validate``,
    ``check_trains`` and the configs' own checks)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        argument_default=argparse.SUPPRESS,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    RunSpec.add_args(ap)
    ap.add_argument("--device", help="cuda (the default) or cpu")
    ns = vars(ap.parse_args(argv))
    device = ns.pop("device", None)
    try:
        spec = RunSpec.from_cli_dict(ns)
        spec.check_trains()
    except SpecError as e:
        raise SystemExit(f"error: {e}")
    return argparse.Namespace(spec=spec, device=device)


def sync_config(opts: argparse.Namespace):
    """The SyncConfig of parsed options."""
    return opts.spec.resolved_sync()


def run(opts: argparse.Namespace, params=None, cfg=None, out=None,
        callbacks=()) -> list:
    """Train ``opts.spec`` through a TrainSession; prints (to ``out``,
    stdout when None) and returns one record per step.  ``params`` (on
    the run's device) replaces the seeded init and ``cfg`` the model
    config of ``--arch`` (tests train an f32 copy); ``callbacks`` run
    after the default ones."""
    try:
        session = TrainSession(opts.spec, default_callbacks(opts.spec, out)
                               + list(callbacks), device=opts.device,
                               params=params, cfg=cfg)
    except (ValueError, NotImplementedError) as e:
        # a bad spec, a mismatched checkpoint, or an ONN that cannot be
        # resolved (with the JAX guidance): before the first step
        raise SystemExit(f"error: {e}")
    try:
        return session.run()
    finally:
        session.close()


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    code = main()
    if distributed.launched():
        distributed.exit_rank(code)
    sys.exit(code)
