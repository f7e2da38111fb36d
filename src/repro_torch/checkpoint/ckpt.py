"""Atomic, resumable checkpoints (counterpart of
``repro.checkpoint.ckpt``), in the JAX package's format, so a JAX
checkpoint loads here and one written here loads in JAX.

Layout:  <dir>/step_<N>/
            manifest.json       step, per-leaf shape/dtype, ``extra`` (the
                                run's RunSpec under extra.run_spec) and a
                                content hash
            arrays.npz          one entry per leaf, keyed by its path:
                                params/..., opt/m/..., opt/v/..., opt/step
                                and, with error feedback, sync/rep and
                                sync/fsdp (or their block-sparse
                                sync/<name>/{idx,val,shape})

Leaves are walked in sorted-key order (``tree.leaves_with_paths``, which
is ``jax.tree_util.tree_flatten``'s order for dicts), bf16 leaves are
stored as f32 (npz cannot hold bf16) and cast back to the template's
dtype on load, and the hash is the same sha256 over each path and the
first 4096 bytes of its array.

Guarantees:
  * atomic: written to step_<N>.tmp, then ``os.replace``d, so a crash
    mid-write never leaves a manifest that validates;
  * resumable: ``latest_step`` skips unreadable or partial checkpoints;
  * async: ``save_checkpoint(..., background=True)`` writes in a thread.
    Every leaf is copied to host memory before the thread starts, so it
    never reads a tensor (on the card or not) that a later step owns.

The JAX loader's ``mesh``/``specs`` placement has no torch meaning: the
port's loader takes a ``device`` instead.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from ..tree import leaves_with_paths, unflatten


def _flatten_with_paths(tree: dict):
    pairs = list(leaves_with_paths(tree))
    return ["/".join(path) for path, _ in pairs], [leaf for _, leaf in pairs]


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array the caller does not share: tensors are
    copied off their device (bf16 widened to f32), numpy arrays copied."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def save_checkpoint(direc, step: int, params, opt_state=None, sync_state=None,
                    extra=None, background: bool = False):
    """Write step ``step``; returns the writer thread when ``background``
    (None otherwise).  ``sync_state`` is in the JAX layout
    (``collectives.residuals_to_jax``, or packed)."""
    direc = pathlib.Path(direc)
    direc.mkdir(parents=True, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    if sync_state:  # error-feedback residuals ({} / None = nothing to save)
        tree["sync"] = sync_state
    paths, leaves = _flatten_with_paths(tree)
    host_leaves = [_to_host(x) for x in leaves]

    def write():
        tmp = direc / f"step_{step}.tmp"
        final = direc / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        arrays = dict(zip(paths, host_leaves))
        np.savez(tmp / "arrays.npz", **arrays)
        h = hashlib.sha256()
        for p in paths:
            h.update(p.encode())
            h.update(arrays[p].tobytes()[:4096])
        manifest = {
            "step": step,
            "leaves": {p: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for p, a in arrays.items()},
            "extra": extra or {},
            "hash": h.hexdigest(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def read_manifest(direc, step: int) -> dict:
    """The manifest dict of one checkpoint (step, leaves, extra, hash),
    without loading the arrays."""
    p = pathlib.Path(direc) / f"step_{step}" / "manifest.json"
    return json.loads(p.read_text())


def read_subtree_arrays(direc, step: int, prefix: str) -> dict:
    """Raw numpy arrays of ONE checkpoint subtree as a nested dict (the
    structure comes from the stored leaf paths, no template): for a
    subtree whose shape the caller cannot know up front, such as the
    block-sparse residuals (``sync/<name>/{idx,val,shape}``)."""
    out: dict = {}
    with np.load(pathlib.Path(direc) / f"step_{step}" / "arrays.npz") as data:
        for p in data.files:
            parts = p.split("/")
            if parts[0] != prefix:
                continue
            node = out
            for seg in parts[1:-1]:
                node = node.setdefault(seg, {})
            node[parts[-1]] = data[p]
    return out


def latest_step(direc) -> int | None:
    direc = pathlib.Path(direc)
    if not direc.exists():
        return None
    steps = []
    for p in direc.glob("step_*"):
        if p.name.endswith(".tmp"):
            continue
        try:
            man = json.loads((p / "manifest.json").read_text())
            steps.append(int(man["step"]))
        except Exception:
            continue  # partial/corrupt checkpoint: skip
    return max(steps) if steps else None


def _from_numpy(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, order="C"))    # 0-d stays 0-d
    return t.to(device=device, dtype=dtype)


def load_checkpoint(direc, step: int, template: dict, device=None):
    """Restore step ``step`` into ``template``'s structure (a nested dict
    whose leaves give shape and dtype: tensors, meta tensors included).
    Each leaf lands on ``device``, or on its template leaf's device when
    None (the CPU for a meta template).  Returns (tree, manifest)."""
    direc = pathlib.Path(direc) / f"step_{step}"
    man = json.loads((direc / "manifest.json").read_text())
    paths, leaves = _flatten_with_paths(template)
    with np.load(direc / "arrays.npz") as data:
        out = [_load_leaf(direc, man, data, p, ref, device)
               for p, ref in zip(paths, leaves)]
    return unflatten(template, out), man


def _load_leaf(direc, man, data, p, ref, device) -> torch.Tensor:
    if p not in data.files:
        raise ValueError(
            f"checkpoint {direc} has no leaf {p!r} (saved leaves: "
            f"{sorted(man['leaves'])[:8]}...) — the template's tree "
            f"structure does not match the saved run")
    arr = data[p]
    want = man["leaves"][p]
    assert list(arr.shape) == want["shape"], (p, arr.shape, want)
    ref_shape = tuple(ref.shape)
    if tuple(arr.shape) != ref_shape:
        # a template whose shape disagrees with the saved leaf is a
        # different run (arch/width/bucket change), not a reshard
        raise ValueError(
            f"checkpoint leaf {p!r}: saved global shape "
            f"{tuple(arr.shape)} != template shape {ref_shape} — the "
            f"checkpoint was written by a run with a different state "
            f"structure and cannot be restored into this one")
    dev = device if device is not None else (
        "cpu" if ref.device.type == "meta" else ref.device)
    return _from_numpy(arr, ref.dtype, dev)


class CheckpointManager:
    """Keeps the last K checkpoints, one background save in flight."""

    def __init__(self, direc, keep: int = 3):
        self.direc = pathlib.Path(direc)
        self.keep = keep
        self._inflight = None

    def save(self, step, params, opt_state=None, sync_state=None, extra=None):
        if self._inflight is not None:
            self._inflight.join()
        self._inflight = save_checkpoint(self.direc, step, params, opt_state,
                                         sync_state, extra, background=True)
        self._gc()

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.direc.glob("step_*")
            if not p.name.endswith(".tmp") and (p / "manifest.json").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.direc / f"step_{s}", ignore_errors=True)
