"""TrainSession hook protocol + the built-in callbacks (counterpart of
``repro.api.callbacks``).

The protocol (all hooks optional; subclass and override what you need):

  on_train_start(session)
  on_step(session, record)       # record: mutable per-step dict; callbacks
                                 # may read/annotate it (step, loss, time_s)
  on_checkpoint(session, step)   # after a checkpoint save is queued
  on_train_end(session)

(JAX's ``on_membership_change`` hook belongs to elastic runs, which are
not ported.)

``on_step_end`` is the legacy name of ``on_step``; the base class keeps
it as a delegating alias, and the session loop calls it.

``session.request_stop()`` ends the loop after the current step;
PeriodicCheckpoint treats a requested stop like a final step, so a
SIGTERM'd run always leaves a fresh checkpoint behind.

Peers as processes (``session.world``): every rank runs the stack.
JsonlLogger writes on rank 0 only; a stop asked on any rank is agreed
by every rank after the step (the session's flag all-reduce), so
SigtermHandler and PeriodicCheckpoint decide alike on every rank, and a
checkpoint is collective.  RankReport (added by ``default_callbacks``
in a launched process) gathers what each rank did and rank 0 prints it.
"""
from __future__ import annotations

import json
import signal
import statistics
import sys
import threading

import torch
import torch.distributed as dist

from ..kernels import launches as kernel_launches
from ..launch import distributed


class Callback:
    def on_train_start(self, session):
        pass

    def on_step(self, session, record: dict):
        pass

    def on_step_end(self, session, record: dict):
        # legacy alias: the loop calls on_step_end; new-style callbacks
        # override on_step, old-style ones override this directly
        self.on_step(session, record)

    def on_checkpoint(self, session, step: int):
        pass

    def on_train_end(self, session):
        pass


class StragglerWatchdog(Callback):
    """Annotates records whose step time exceeds ``factor`` x the rolling
    median (keep this BEFORE the logger).

    ``factor <= 0`` disables the watchdog (``--watchdog 0``): no timing
    history is kept and records are never annotated.  The rolling window
    keeps sliding past a straggler, so one straggler does not poison the
    median for later steps.  ``n_flagged`` counts the stragglers seen.
    (JAX's escalation of repeated flags to a membership registry,
    ``--evict-after``, is elastic and not ported.)
    """

    def __init__(self, factor: float = 3.0, window: int = 50,
                 warmup: int = 10):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.times = []
        self.n_flagged = 0

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    def on_step(self, session, record):
        if not self.enabled:
            return
        dt = record.get("time_s", 0.0)
        self.times.append(dt)
        med = statistics.median(self.times[-self.window:])
        if len(self.times) > self.warmup and dt > self.factor * med:
            record["straggler"] = True
            self.n_flagged += 1


class JsonlLogger(Callback):
    """One JSON line per step to ``out`` (stdout when None) and,
    optionally, to a file."""

    def __init__(self, path: str = "", out=None):
        self.path = path
        self.out = out
        self._f = None

    def on_train_start(self, session):
        if self.path and session.rank == 0:
            self._f = open(self.path, "a")

    def on_step(self, session, record):
        if session.rank:
            return
        line = json.dumps(record)
        print(line, file=self.out or sys.stdout, flush=True)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()

    def on_train_end(self, session):
        if self._f:
            self._f.close()
            self._f = None


class PeriodicCheckpoint(Callback):
    """Save every N steps, on a requested stop, and at the end of every
    run() call (so a partial ``run(n_steps)`` never loses its state)."""

    def __init__(self, every: int = 50):
        self.every = max(1, every)
        self._last_run = None
        self._last_saved = None

    def on_train_start(self, session):
        self._last_run = None

    def on_step(self, session, record):
        step = record["step"]
        self._last_run = step
        if session.mgr and ((step + 1) % self.every == 0
                            or session.stop_requested
                            or step == session.spec.steps - 1):
            session.save_checkpoint(step)
            self._last_saved = step

    def on_train_end(self, session):
        if session.mgr:
            if self._last_run is not None and self._last_saved != self._last_run:
                session.save_checkpoint(self._last_run)
                self._last_saved = self._last_run
            session.mgr.wait()


class SigtermHandler(Callback):
    """SIGTERM/SIGINT request a stop (and thus a final checkpoint) instead
    of killing the loop mid-step.  Handlers are restored on train end.
    Python takes signal handlers only in the main thread, so a session
    run from another thread installs none."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._previous = {}

    def on_train_start(self, session):
        if threading.current_thread() is not threading.main_thread():
            return

        def handler(sig, frame):
            print(f"signal {sig}: checkpointing and exiting", flush=True)
            session.request_stop()
        for s in self.signals:
            self._previous[s] = signal.signal(s, handler)

    def on_train_end(self, session):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous = {}


class RankReport(Callback):
    """Peers as processes: at the end of a run() call rank 0 prints one
    JSON line ``{"ranks": [...], "steps", "losses"}``: per rank its
    device, the bytes it handed to each collective ("op:dtype"; by axis
    as "axis/op:dtype" in ``axis_bytes``), its kernel launches during the
    run and, on a card, ``torch.cuda.max_memory_allocated`` since the
    run started, and the run's losses whole (the step records round
    them).  Collective: every rank runs it."""

    def __init__(self, out=None):
        self.out = out
        self._bytes = self._axis_bytes = self._launches = None
        self._steps = []

    def on_train_start(self, session):
        self._bytes = dict(session.world.bytes)
        self._axis_bytes = dict(session.world.axis_bytes)
        self._launches = kernel_launches()
        self._steps = []
        if session.world.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(session.world.device)

    def on_step(self, session, record):
        self._steps.append(record["step"])

    def on_train_end(self, session):
        w = session.world
        mine = {"rank": w.rank, "device": str(w.device),
                "collective_bytes": {k: v - self._bytes.get(k, 0)
                                     for k, v in w.bytes.items()
                                     if v != self._bytes.get(k, 0)},
                "axis_bytes": {k: v - self._axis_bytes.get(k, 0)
                               for k, v in w.axis_bytes.items()
                               if v != self._axis_bytes.get(k, 0)},
                "launches": {k: v - self._launches[k]
                             for k, v in kernel_launches().items()},
                "peak_bytes": (torch.cuda.max_memory_allocated(w.device)
                               if w.device.type == "cuda" else None)}
        ranks = [None] * w.size
        dist.all_gather_object(ranks, mine)
        if w.rank == 0:
            print(json.dumps({"ranks": ranks, "steps": len(self._steps),
                              "losses": [session.losses[s]
                                         for s in self._steps]}),
                  file=self.out or sys.stdout, flush=True)


def default_callbacks(spec, out=None) -> list:
    """The train CLI's stack for a RunSpec; ``out`` takes the JSON lines
    (stdout when None); in a launched process also RankReport."""
    stack = [StragglerWatchdog(spec.watchdog),
             JsonlLogger(spec.log, out=out),
             PeriodicCheckpoint(spec.ckpt.every),
             SigtermHandler()]
    return stack + ([RankReport(out)] if distributed.launched() else [])
