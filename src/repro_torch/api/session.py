"""TrainSession: build -> init-or-resume -> step loop (counterpart of
``repro.api.session``).

Owns parameter/optimizer/sync-state initialization over the stacked
peers, checkpoint resume with RunSpec compatibility validation, the
training step, and a callback stack for logging / checkpointing /
signal handling / straggler detection.

Checkpoints hold the full step state (params, AdamW moments and step,
and the error-feedback residuals in the JAX layout) plus the RunSpec in
the manifest, so ``--resume`` restores a run bit for bit and refuses a
spec whose state structure does not match.  Step i's batch is
``SyntheticLM.batch(i)`` and its sync key ``prng.fold_in(PRNGKey(seed +
1), i)``, so a resumed step sees exactly the inputs an uninterrupted
run's step sees.  At fidelities onn and mesh the in-network ONN is
resolved at start-up (``build.warmup_photonics``), never read from a
checkpoint.

Peers as processes: a session started as one rank of a launch
(``launch.distributed.launched``; torchrun sets the environment) is
rank RANK of the ``pods * dp * tp`` processes of the (pod, data, model)
mesh, on card ``LOCAL_RANK`` (or the CPU, gloo); the world must be that
size (``RunSpec.check_launch``), and tp > 1 runs only so.  Unsharded,
each rank seeds the same parameters and rank 0's are broadcast once
after init or resume; sharded (tp > 1 or ``--fsdp``) each rank seeds
the same global parameters and keeps its shards
(``steps.to_local``).  Each rank keeps its own residual rows.  A
checkpoint is collective and in JAX's layout: each leaf the padded
global array (shards gathered to rank 0's host leaf by leaf, of a
replicated leaf rank 0's copy, as JAX's ``np.asarray`` gives device
0's), the residual rows gathered in rank order; rank 0 writes it, and
every rank meets at a barrier after the save.  On resume each rank takes its shards and its rows, so a
stacked checkpoint resumes as processes and the other way round.  A
stop asked on any rank (``request_stop``, a signal) is agreed by an
all-reduce over the whole world after the step, so the ranks never
part ways.
"""
from __future__ import annotations

import time

import torch

from .. import device as device_util
from .. import prng
from ..checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                          read_manifest, read_subtree_arrays)
from ..collectives import (is_packed_residuals, pack_residuals,
                           residuals_from_jax, residuals_to_jax,
                           unpack_residuals)
from ..data.pipeline import SyntheticLM
from ..launch import distributed, steps
from ..models import lm
from ..optim.adamw import adamw_init
from ..tree import leaves, tree_map
from . import build
from .callbacks import default_callbacks
from .spec import RunSpec, SpecError, validate_resume_compat

_REZEROED = ("resharded resume: error-feedback residual buckets changed "
             "shape; residuals re-zeroed")


class TrainSession:
    """One training run of one RunSpec, on ``device`` (CUDA when None;
    raises when there is none).  ``params`` replaces the seeded init and
    ``cfg`` the spec's model config (a test trains an f32 copy).

    >>> spec = RunSpec(arch="minitron_4b", smoke=True, steps=3)
    >>> history = TrainSession(spec, device="cpu").run()
    """

    def __init__(self, spec: RunSpec, callbacks: list | None = None, *,
                 device=None, params=None, cfg=None):
        spec.validate()
        spec.check_trains(cfg)
        launched = distributed.launched()
        spec.check_launch(launched,
                          distributed.world_size() if launched else 0)
        self.device = device_util.resolve(device, "TrainSession")
        m = spec.mesh
        # launch.distributed.ProcessAxes of the process mesh, else None
        self.world = (distributed.init(m.pods, m.dp, m.tp, self.device)
                      if launched else None)
        self.spec = spec
        self.ctx = m.ctx()
        self.cfg = cfg if cfg is not None else spec.model_config()
        self.peers = m.peers              # pods * dp, peer p = pod * dp + d
        self.sync = spec.resolved_sync()
        self.callbacks = (list(callbacks) if callbacks is not None
                          else default_callbacks(spec))
        self.mgr = (CheckpointManager(spec.ckpt.dir, keep=spec.ckpt.keep)
                    if spec.ckpt.dir else None)
        self.data = SyntheticLM(spec.resolved_data(self.cfg))
        self.stop_requested = False
        self._stop_asked = False   # on this rank, not yet agreed
        self.step = 0              # next step to execute
        self.losses = {}           # step -> loss as the device gave it

        if params is None and self.world is not None and self.ctx.sharded:
            self.params = lm.init_params(self.cfg, spec.seed, self.device,
                                         self.ctx, self.world.coords)
        else:
            self.params = self._local(
                lm.init_params(self.cfg, spec.seed, self.device, self.ctx)
                if params is None else params)
        self.opt_state = adamw_init(spec.optim, self.params)
        self.sync_state = build.init_sync_state(spec, self.cfg, self.device,
                                                self.world)
        if spec.ckpt.resume:
            self._maybe_resume()
        if self.world is not None and not self.ctx.sharded:
            self.world.broadcast_(leaves(self.params))

        build.warmup_photonics(spec, self.device)
        self._step_fn = build.build_train_step(spec, self.cfg, self.device,
                                               self.world)
        self._base_key = prng.PRNGKey(spec.seed + 1)

    @property
    def rank(self) -> int:
        """This process's rank as one of several processes, else 0."""
        return 0 if self.world is None else self.world.rank

    def _local(self, tree: dict):
        """Global params as this run's state (``steps.to_local``)."""
        return steps.to_local(tree, self.cfg, self.ctx, self.world)

    # ------------------------------------------------------------ control
    def request_stop(self):
        """End the loop after the current step (checkpoint included); as
        one of several processes, after the step every rank agrees on."""
        if self.world is None:
            self.stop_requested = True
        self._stop_asked = True

    def close(self):
        """End the process group of peers as processes (the CLI, when
        the run is over); nothing for stacked peers."""
        if self.world is not None:
            distributed.shutdown()
            self.world = None

    def save_checkpoint(self, step: int | None = None):
        """Persist params + optimizer + residuals + the RunSpec manifest
        (in the background; ``mgr.wait()`` joins it).  With
        ``sync.sparse_residuals`` the residuals are stored
        block-sparsely."""
        if self.mgr is None:
            return
        step = (self.step - 1) if step is None else step
        sync_state = self.sync_state
        if self.world is not None:      # rank 0 gets every rank's rows
            sync_state = {k: self.world.gather_to_root(v)
                          for k, v in sync_state.items()}
            sync_state = {k: v.reshape(v.shape[0], -1)
                          for k, v in sync_state.items() if v is not None}
        # JAX's global arrays (collective: rank 0 gets them on its host)
        params = steps.to_global(self.params, self.cfg, self.ctx, self.world)
        opt_state = steps.opt_to_global(self.opt_state, self.cfg, self.ctx,
                                        self.world)
        if self.rank == 0:
            sync_state = residuals_to_jax(sync_state)
            if self.sync.sparse_residuals and sync_state:
                sync_state = pack_residuals(sync_state)
            self.mgr.save(step, params, opt_state,
                          sync_state=sync_state,
                          extra={"run_spec": self.spec.to_json_dict(),
                                 "arch": self.cfg.name,
                                 "sync": self.sync.mode})
        if self.world is not None:
            self.mgr.wait()
            self.world.barrier()
        for cb in self.callbacks:
            cb.on_checkpoint(self, step)

    def _own_rows(self, state: dict) -> dict:
        """(N, size) residual rows -> this process's (1, size) rows, on
        the run's device."""
        if self.world is None:
            return {k: v.to(self.device) for k, v in state.items()}
        r = self.world.rank
        return {k: v[r:r + 1].to(self.device, copy=True)
                for k, v in state.items()}

    def _maybe_resume(self):
        c = self.spec.ckpt
        s = latest_step(c.dir)
        if s is None:
            return
        man = read_manifest(c.dir, s)
        saved_spec = (man.get("extra") or {}).get("run_spec")
        resharded, saved = False, None
        if saved_spec is not None:
            saved = RunSpec.from_json_dict(saved_spec)
            compat = validate_resume_compat(
                saved, self.spec, allow_reshard=self.spec.elastic.allow_reshard)
            resharded = compat.verdict == "reshardable"
        if self.ctx.sharded:    # global leaves, read on the host
            shapes = lm.param_shapes(self.cfg, self.ctx)

            def meta(dt, shape=None):
                if shape is not None:
                    return torch.empty(shape, dtype=dt, device="meta")
                return tree_map(lambda sh: meta(dt, sh), shapes)
            template = {"params": meta(lm.torch_dtype(self.cfg)),
                        "opt": {"m": meta(torch.float32),
                                "v": meta(torch.float32),
                                "step": meta(torch.int32, ())}}
        else:
            template = {"params": self.params, "opt": self.opt_state}
        sync_paths = [p for p in man["leaves"]
                      if p.split("/", 1)[0] == "sync"]
        # block-sparse checkpoints store sync/<name>/{idx,val,shape};
        # either form restores whatever the current flag says
        sync_packed = bool(sync_paths) and all(
            p.rsplit("/", 1)[-1] in ("idx", "val", "shape")
            for p in sync_paths)
        devices = self.spec.mesh.devices
        want = residuals_to_jax(
            {k: v.new_zeros((devices, v.shape[1]))
             for k, v in self.sync_state.items()})
        sync_shapes_ok = want and sync_paths and all(
            list((man["leaves"].get(f"sync/{name}") or {}).get("shape", ()))
            == list(v.shape) for name, v in want.items())
        if want and sync_paths and not sync_packed:
            if sync_shapes_ok or not resharded:
                # an exact resume keeps the strict path: a shape mismatch
                # without a peer-count change is corruption, and
                # load_checkpoint names the offending leaf
                template["sync"] = want
            else:
                print(_REZEROED, flush=True)
        elif want and not sync_paths:
            print("checkpoint predates sync_state persistence; "
                  "error-feedback residuals restart from zero", flush=True)
        tree, _ = load_checkpoint(
            c.dir, s, template,
            device="cpu" if self.ctx.sharded else self.device)
        if self.ctx.sharded:    # this run's shards, on its device
            params = self._local(tree["params"])
            opt = steps.opt_to_local(tree["opt"], self.cfg, self.ctx,
                                     self.world)
            on = lambda t: tree_map(lambda x: x.to(self.device), t)
            tree["params"], tree["opt"] = on(params), on(opt)
        self.params, self.opt_state = tree["params"], tree["opt"]
        if "sync" in tree:
            self.sync_state = self._own_rows(
                residuals_from_jax(tree["sync"], devices))
        elif want and sync_packed:
            try:
                self.sync_state = self._load_packed_sync(c.dir, s, want)
            except ValueError:
                if not resharded:
                    raise
                print(_REZEROED, flush=True)
        self.step = s + 1
        note = ""
        if resharded and saved is not None:
            note = (f" (resharded {saved.mesh.shape} -> "
                    f"{self.spec.mesh.shape}; data pipeline continues at "
                    f"sample offset of step {s + 1})")
        if self.rank == 0:
            print(f"resumed from step {s}{note}", flush=True)

    def _load_packed_sync(self, direc, step: int, want: dict) -> dict:
        """Restore block-sparse residuals: read the packed sync/ subtree,
        expand it to dense, check it against the run's JAX-layout
        template ``want`` and map it to the port's rows."""
        packed = read_subtree_arrays(direc, step, "sync")
        if not is_packed_residuals(packed):
            raise ValueError(
                f"checkpoint step {step} has a malformed block-sparse "
                f"sync/ subtree (entries: "
                f"{ {k: sorted(v) for k, v in packed.items()} })")
        dense = unpack_residuals(packed)
        state = {}
        for name, ref in want.items():
            got = dense.get(name)
            if got is None or tuple(got.shape) != tuple(ref.shape):
                raise ValueError(
                    f"packed sync_state {name!r} does not match the run: "
                    f"checkpoint {None if got is None else got.shape} vs "
                    f"run {tuple(ref.shape)}")
            state[name] = torch.from_numpy(got).to(self.device)
        return self._own_rows(residuals_from_jax(state,
                                                 self.spec.mesh.devices))

    # ------------------------------------------------------------ the loop
    def run_step(self, step: int) -> dict:
        """Execute one training step; its record (the loss rounded to 5
        digits, as the JAX session prints it; ``self.losses`` keeps it
        whole)."""
        t0 = time.perf_counter()
        tokens = torch.from_numpy(self.data.batch(step)).to(self.device)
        (self.params, self.opt_state, self.sync_state,
         metrics) = self._step_fn(self.params, self.opt_state,
                                  self.sync_state, tokens,
                                  prng.fold_in(self._base_key, step))
        loss = float(metrics["loss"])          # waits for the device
        self.losses[step] = loss
        return {"step": step, "loss": round(loss, 5),
                "time_s": round(time.perf_counter() - t0, 6)}

    def run(self, n_steps: int | None = None) -> list:
        """Run to ``spec.steps`` (or ``n_steps`` more), firing callbacks.
        Returns the per-step records."""
        end = (self.spec.steps if n_steps is None
               else min(self.spec.steps, self.step + n_steps))
        history = []
        for cb in self.callbacks:
            cb.on_train_start(self)
        try:
            while self.step < end and not self.stop_requested:
                record = self.run_step(self.step)
                self.step = record["step"] + 1
                if self.world is not None:
                    self.stop_requested = self.world.any(self._stop_asked)
                for cb in self.callbacks:
                    cb.on_step_end(self, record)
                history.append(record)
        finally:
            for cb in self.callbacks:
                cb.on_train_end(self)
        return history

