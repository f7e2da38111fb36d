"""Parameter resolution + checkpoint hot-swap for the serving tier
(counterpart of ``repro.serving.reload``).

``resolve_params`` is the one "where do serving weights come from"
decision (shared by ServeSession and ServeEngine.from_spec): the spec's
checkpoint directory when ``ckpt.dir`` + ``ckpt.resume`` are set, else a
fresh seeded init.  ``ParamReloader`` polls the same directory for a
NEWER step between engine steps, so a live engine picks up a concurrently
training run's checkpoints without a restart; a step runs entirely on
the old or entirely on the new parameters, never a mix.
"""
from __future__ import annotations

import os

import torch

from ..checkpoint.ckpt import latest_step, load_checkpoint
from ..models import lm
from ..tree import leaves_with_paths, set_path


def load_params(spec, cfg, step: int, device) -> dict:
    """Params of checkpoint ``step`` on ``device``.  The template is of
    meta tensors: load_checkpoint only reads its structure, shapes and
    dtypes, so no throwaway init is materialized."""
    dt = lm.torch_dtype(cfg)
    template: dict = {}
    for path, shape in leaves_with_paths(lm.param_shapes(cfg)):
        set_path(template, path, torch.empty(shape, dtype=dt, device="meta"))
    tree, _ = load_checkpoint(spec.ckpt.dir, step, {"params": template},
                              device=device)
    return tree["params"]


def resolve_params(spec, cfg, device):
    """(params, checkpoint_step | None): the newest checkpoint when the
    spec asks to resume from one, else a fresh seeded init."""
    c = spec.ckpt
    step = latest_step(c.dir) if (c.dir and c.resume) else None
    if step is None:
        return lm.init_params(cfg, spec.seed, device), None
    print(f"serving params from checkpoint step {step}", flush=True)
    return load_params(spec, cfg, step, device), step


class ParamReloader:
    """Hot-swap poller over ``spec.ckpt.dir``.

    ``poll()`` returns (params, step) when a checkpoint newer than
    ``current_step`` has appeared (None while nothing changed); partial
    writes are invisible because ``save_checkpoint`` os.replace()s the
    step directory atomically and ``latest_step`` skips anything without
    a readable manifest.

    The idle path costs one ``os.stat``: a new checkpoint changes the
    directory's mtime (``os.replace`` of the step dir into it), so the
    listing runs only when the stat says something moved.  The stat is
    taken BEFORE the listing, so a checkpoint landing between the two is
    seen by this poll or moves the mtime past the recorded one.
    """

    def __init__(self, spec, cfg, device, current_step=None):
        if not spec.ckpt.dir:
            raise ValueError("ParamReloader needs spec.ckpt.dir")
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.current_step = -1 if current_step is None else current_step
        self._dir_mtime_ns = None

    def poll(self):
        try:
            mtime = os.stat(self.spec.ckpt.dir).st_mtime_ns
        except OSError:
            return None  # directory not created yet: nothing to swap to
        if mtime == self._dir_mtime_ns:
            return None
        step = latest_step(self.spec.ckpt.dir)
        self._dir_mtime_ns = mtime
        if step is None or step <= self.current_step:
            return None
        params = load_params(self.spec, self.cfg, step, self.device)
        self.current_step = step
        return params, step
