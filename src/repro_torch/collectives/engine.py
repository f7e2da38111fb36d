"""Bucketed gradient-sync engine over stacked peers (counterpart of
``repro.collectives.engine``).

``sync_gradients`` flattens the peers' gradient leaves into an
(N, total) f32 stack, slices it into fused buckets, and runs the
backend resolved from ``SyncConfig.mode`` once per bucket: O(ceil(total
bytes / bucket_bytes)) launches per step.  A backend sees each bucket
with one leading peer dimension a sync axis: (N, m) over ('data',),
(pods, N / pods, m) over ('pod', 'data') (``pods``; peer p = pod * dp
+ d, as JAX's (pod, data) mesh splits the batch).

``SyncConfig.overlap`` selects between two dispatch strategies, as in
JAX:

* overlap off: the barrier path, every bucket after the whole stack
  (JAX's ``lax.scan`` over full buckets is a Python loop here, bit-exact
  with it since the per-bucket math is the same);
* overlap on: the streaming path, a ``BucketStream`` told leaf by leaf
  that a leaf is written, which launches each bucket as soon as all its
  leaves are (on the card on a side CUDA stream, so the sync overlaps
  the rest of the backward).  The trainer (``launch.steps``) feeds it
  from the last peer's backward; ``sync_gradients`` in the order its
  ``readiness`` model says the backward emits the leaves, so the
  buckets go in ``launch_order``.
  Per bucket the key (``split(key, n_buckets)[b]`` by bucket index), the
  residual slice and the math are the barrier path's, so overlap changes
  when buckets run, never the numbers.

A per-step sync key (``prng``) is split into one key per bucket, as
the JAX engine splits it; the photonic noise and Table-II injection
draw from it.

Error feedback (beyond the paper) is a per-peer f32 residual over the
concatenated-leaf space, (N, total): it is added to the gradient stack
before quantization and replaced by each peer's quantization error.
A checkpoint stores it in the JAX package's layout (``residuals_to_jax``
and ``residuals_from_jax``, the one place that maps the two), and with
``SyncConfig.sparse_residuals`` block-sparsely (``pack_residuals``).

Peers as processes (``world``, a ``launch.distributed.ProcessAxes``):
the stack is this rank's (1, total) row and its residual row, and each
backend runs its collectives over the sync axes.  Every rank must issue
its collectives in the same order, so a ``BucketStream`` then launches
the buckets in the static ``launch_order`` and never lets a ready
bucket pass an earlier one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from ..photonics.config import PhotonicsConfig
from ..photonics.error_model import TABLE_II
from ..tree import leaves as tree_leaves
from ..tree import unflatten
from . import backends  # noqa: F401  (registers the four backends)
from .bucketizer import (DEFAULT_BUCKET_BYTES, bucket_segments,
                         emission_order, launch_order, make_layout,
                         unbucketize)
from .registry import get_backend


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "optinc"            # psum | ring | optinc | cascade
    # the JAX mesh axes to sync over: ("data",), or ("pod", "data") for a
    # pod axis; the peers of each axis are one leading dimension here
    axes: tuple = ("data",)
    bits: int = 8                    # OptINC gradient bit width B
    block: int = 2048                # quantization block size (0 = global)
    error_layers: tuple = ()         # Table II key; () = ideal ONN only
    error_feedback: bool = False     # beyond-paper residual accumulation
    bucket_bytes: int = DEFAULT_BUCKET_BYTES  # fused-bucket wire payload
    # stream buckets in gradient-readiness order so the sync overlaps the
    # rest of the backward (module docstring; bit-exact vs overlap off)
    overlap: bool = False
    # checkpoint the residuals block-sparsely (only the blocks with a
    # nonzero carry; pack_residuals), the runtime state stays dense
    sparse_residuals: bool = False
    # emulation fidelity of the optinc backend: behavioral | onn (the
    # trained dense ONN inside the collective) | mesh (its MZI meshes)
    photonics: PhotonicsConfig = PhotonicsConfig()

    def __post_init__(self):
        get_backend(self.mode)
        if self.error_layers and tuple(self.error_layers) not in TABLE_II:
            raise ValueError(
                f"error_layers {tuple(self.error_layers)} is not a row of "
                f"Table II: one of {sorted(TABLE_II)}")
        if self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got "
                             f"{self.bucket_bytes}")
        ph = self.photonics
        if not isinstance(ph, PhotonicsConfig):
            raise TypeError(f"SyncConfig.photonics must be a "
                            f"PhotonicsConfig, got {ph!r}")
        if ((ph.theta_drift_std > 0 or ph.shot_noise_std > 0)
                and ph.fidelity != "mesh"):
            raise ValueError(
                f"--theta-drift-std/--shot-noise-std model the emulated MZI "
                f"mesh (PhaseNoise) and only apply to --fidelity mesh; got "
                f"--fidelity {ph.fidelity}")
        if (ph.fidelity != "behavioral"
                and self.mode not in ("optinc", "cascade")):
            raise ValueError(
                f"--fidelity {ph.fidelity} is a photonic-backend knob (the "
                f"hardware-in-the-loop ONN path of optinc/cascade); got "
                f"--sync {self.mode}")


def residual_size(leaves) -> int:
    """Length of one peer's error-feedback residual for a leaf list
    (tensors, meta ones included): the concatenated element count."""
    return sum(l.numel() for l in leaves)


# ------------------ the residuals in a checkpoint ------------------
#
# The port keeps {"rep": (N, rep), "fsdp": (N, fsdp)}, one row a device
# (a stacked peer, or a rank of the process mesh in rank order), "fsdp"
# only under FSDP.  The JAX package keeps {"rep": (N * rep,), "fsdp":
# (N * fsdp,)}: device i's local residual is slice i of each vector (the
# vectors are sharded over every mesh axis), and "fsdp" is (0,) without
# FSDP.  Row-major flattening maps one onto the other.

def residuals_to_jax(state: dict) -> dict:
    """The port's sync state in the JAX layout (views, no copy)."""
    if not state:
        return {}
    rep = state["rep"]
    fsdp = state.get("fsdp")
    return {"rep": rep.reshape(-1),
            "fsdp": rep.new_zeros((0,)) if fsdp is None else fsdp.reshape(-1)}


def residuals_from_jax(state: dict, peers: int) -> dict:
    """A JAX-layout sync state (tensors) as the port's (peers, size)
    rows, ``peers`` the devices of the mesh; an empty FSDP group is
    left out."""
    if not state:
        return {}
    out = {}
    for name, vec in state.items():
        if name == "fsdp" and not vec.numel():
            continue
        if vec.ndim != 1 or vec.numel() % peers:
            raise ValueError(f"{'FSDP' if name == 'fsdp' else name} "
                             f"residual vector of shape {tuple(vec.shape)} "
                             f"does not split over {peers} peers")
        out[name] = vec.reshape(peers, -1)
    return out


# ------------------- block-sparse residual checkpointing -------------------
#
# With ``SyncConfig.sparse_residuals`` a checkpoint stores, per residual
# vector, only the blocks with a nonzero carry: {"idx", "val", "shape"},
# ``shape`` = (size, block).  The round trip is lossless.  The functions
# take and give host numpy arrays, as the JAX ones do.

RESIDUAL_BLOCK = 4096  # f32 elements per stored block (16 KiB)


def _host(vec) -> np.ndarray:
    if torch.is_tensor(vec):
        vec = vec.detach().cpu().numpy()
    return np.asarray(vec, np.float32).reshape(-1)


def pack_residuals(state: dict, block: int = RESIDUAL_BLOCK) -> dict:
    """Dense sync state ({name: 1-D f32}) -> block-sparse host form."""
    packed = {}
    for name, vec in state.items():
        v = _host(vec)
        n = v.size
        nb = -(-n // block) if n else 0
        full = np.zeros((nb * block,), np.float32)
        full[:n] = v
        blocks = full.reshape(nb, block)
        idx = np.flatnonzero(np.any(blocks != 0.0, axis=1)).astype(np.int32)
        packed[name] = {"idx": idx, "val": blocks[idx],
                        "shape": np.array([n, block], np.int64)}
    return packed


def unpack_residuals(packed: dict) -> dict:
    """Block-sparse checkpoint form -> dense numpy sync state."""
    state = {}
    for name, entry in packed.items():
        n, block = (int(x) for x in np.asarray(entry["shape"]))
        nb = -(-n // block) if n else 0
        full = np.zeros((nb * block,), np.float32)
        idx = np.asarray(entry["idx"], np.int64)
        if idx.size:
            full.reshape(nb, block)[idx] = np.asarray(entry["val"],
                                                      np.float32)
        state[name] = full[:n]
    return state


def is_packed_residuals(tree) -> bool:
    """True when a checkpointed sync subtree is in the block-sparse form
    (each entry an {"idx", "val", "shape"} dict) rather than dense
    vectors; resume takes either form whatever the current flag."""
    return bool(tree) and all(
        isinstance(v, dict) and set(v) == {"idx", "val", "shape"}
        for v in tree.values())


def peer_view(x: torch.Tensor, cfg: SyncConfig, pods: int = 1):
    """An (N, m) peer stack as the backends see it: one leading
    dimension a sync axis, (pods, N / pods, m) over ('pod', 'data')."""
    if len(cfg.axes) != 2:
        return x
    if x.shape[0] % pods:
        raise ValueError(f"{x.shape[0]} peers do not split into {pods} "
                         f"pods")
    return x.reshape(pods, x.shape[0] // pods, x.shape[1])


def _bucket_sync(backend, flat, residual, bounds, cfg, key, pods, world):
    """One bucket of the (N, total) stack, with its residual slice."""
    s, e = bounds
    x = flat[:, s:e]
    if residual is not None:
        x = x + residual[:, s:e]
    if world is not None:
        return backend.sync(x, cfg, key, world)
    return backend.sync(peer_view(x, cfg, pods), cfg, key)


def _bucket_keys(key, nb: int) -> list:
    return [None] * nb if key is None else prng.split(key, nb)


def _new_residual(cfg, errs):
    if cfg.error_feedback and errs and all(e is not None for e in errs):
        return torch.cat(errs, dim=1)
    return None


def sync_flat(flat: torch.Tensor, bounds, cfg: SyncConfig,
              residual: torch.Tensor | None = None, key=None,
              pods: int = 1, world=None):
    """Sync an (N, total) f32 gradient stack bucket by bucket (the
    barrier path).

    ``bounds``: the layout's (start, end) bucket slices; ``key``: the
    step's sync key (``prng``), split into one key a bucket; ``pods``:
    the size of the 'pod' axis when ``cfg.axes`` has one; ``world``: the
    ranks of peers as processes, ``flat`` then this rank's (1, total)
    row.  Returns ``(synced, new_residual)``: the (total,) average every
    peer receives and, when ``cfg.error_feedback`` and the backend
    reports a quantization error, the (N, total) residual for the next
    step (None otherwise)."""
    backend = get_backend(cfg.mode)
    res = residual if cfg.error_feedback else None
    synced = flat.new_empty(flat.shape[1])
    errs = []
    for (s, e), k in zip(bounds, _bucket_keys(key, len(bounds))):
        synced[s:e], err = _bucket_sync(backend, flat, res, (s, e), cfg, k,
                                        pods, world)
        errs.append(err)
    return synced, _new_residual(cfg, errs)


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    """One side CUDA stream a device for every step's bucket syncs: the
    caching allocator keeps blocks per stream, so a new stream each step
    would allocate the syncs' buffers anew every step."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class BucketStream:
    """The streaming dispatch of one step over an (N, total) stack that
    the backward fills leaf by leaf.

    ``leaf_ready(i)`` says that leaf i of the layout is written for every
    peer; a bucket is launched as soon as all the leaves it spans are.
    On the card each launch runs on a side CUDA stream, ordered after
    the writes by ``wait_stream`` (the stack, residual and output are
    marked with ``record_stream``), so the sync overlaps the rest of the
    backward; on the CPU it runs inline.  ``finish()`` joins the side
    stream and returns ``(synced, new_residual)`` as ``sync_flat`` does,
    bit for bit.  ``order`` keeps the buckets in the order they were
    launched, ``early`` counts those launched while leaves were still
    outstanding, i.e. before the backward ended; ``finish`` lets go of
    the tensors, so a finished stream keeps only those two.

    With ``world`` (peers as processes) a ready bucket waits until every
    bucket before it in ``launch_order(layout, readiness)`` has been
    launched, so every rank issues its collectives in one order."""

    def __init__(self, layout, cfg: SyncConfig, flat: torch.Tensor,
                 residual: torch.Tensor | None = None, key=None,
                 pods: int = 1, world=None, readiness=None):
        self.backend = get_backend(cfg.mode)
        self.layout, self.cfg, self.flat, self.pods = layout, cfg, flat, pods
        self.world = world
        self.schedule = (launch_order(layout, readiness)
                         if world is not None else None)
        self.ready = set()
        self.residual = residual if cfg.error_feedback else None
        nb = layout.n_buckets
        self.keys = _bucket_keys(key, nb)
        segs = bucket_segments(layout)
        self.waiting = [{i for i, _, _ in seg} for seg in segs]
        self.covers = [[] for _ in layout.sizes]
        # a leaf that completes several buckets launches them last first,
        # as launch_order breaks its ties
        for b, seg in reversed(list(enumerate(segs))):
            for i, _, _ in seg:
                self.covers[i].append(b)
        self.outstanding = sum(1 for c in self.covers if c)
        self.synced = flat.new_empty(layout.total)
        self.errs = [None] * nb
        self.order, self.early = [], 0
        self.stream = _side_stream(flat.device) if flat.is_cuda else None

    def leaf_ready(self, i: int) -> None:
        if self.covers[i]:
            self.outstanding -= 1
        for b in self.covers[i]:
            self.waiting[b].discard(i)
            if not self.waiting[b]:
                self._ready(b)

    def _ready(self, b: int) -> None:
        if self.schedule is None:
            self._launch(b)
            return
        self.ready.add(b)
        while (len(self.order) < len(self.schedule)
               and self.schedule[len(self.order)] in self.ready):
            self._launch(self.schedule[len(self.order)])

    def _launch(self, b: int) -> None:
        self.order.append(b)
        self.early += self.outstanding > 0
        if self.stream is None:
            self._sync(b)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.flat.device))
        if len(self.order) == 1:
            for t in (self.flat, self.residual, self.synced):
                if t is not None:
                    t.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            self._sync(b)

    def _sync(self, b: int) -> None:
        s, e = self.layout.bounds[b]
        self.synced[s:e], self.errs[b] = _bucket_sync(
            self.backend, self.flat, self.residual, (s, e), self.cfg,
            self.keys[b], self.pods, self.world)

    def finish(self):
        missing = sorted(set(range(self.layout.n_buckets)) - set(self.order))
        if missing:
            raise RuntimeError(
                f"buckets {missing} were never launched: not every leaf "
                f"was reported ready (did the gradient hooks fire?)")
        if self.stream is not None:
            main = torch.cuda.current_stream(self.flat.device)
            main.wait_stream(self.stream)
            for err in self.errs:
                if err is not None:
                    err.record_stream(main)
        out = self.synced, _new_residual(self.cfg, self.errs)
        self.flat = self.residual = self.synced = self.errs = None
        return out


def sync_gradients(grads, cfg: SyncConfig,
                   residual: torch.Tensor | None = None, key=None,
                   readiness=None, pods: int = 1, world=None):
    """Synchronize (average) ``grads`` over the peers.

    ``grads``: a dict (walked in sorted-key order, like
    ``jax.tree.flatten``) or list of tensors, each with a leading peer
    dim N.  Returns ``(synced, new_residual)``: ``synced`` has the
    structure of ``grads`` without the peer dim (every peer receives
    the same average), ``new_residual`` is as ``sync_flat``'s; ``key``
    is the step's sync key, ``pods`` the 'pod' axis size.  With
    ``cfg.overlap`` a ``BucketStream`` is told of the leaves in the
    order the backward emits them, so the buckets launch in
    ``launch_order``; ``readiness`` (per-leaf emission ranks,
    ``launch.steps.grad_readiness``) overrides its reverse-tree-order
    model of the backward.  ``world``: peers as processes, each leaf
    then this rank's (1, ...) gradient."""
    is_dict = isinstance(grads, dict)
    leaves = tree_leaves(grads) if is_dict else list(grads)
    if not leaves:
        return grads, residual
    n = leaves[0].shape[0]
    layout = make_layout([(l.shape[1:], l.dtype) for l in leaves],
                         cfg.bucket_bytes)
    flat = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)
    if cfg.overlap:
        stream = BucketStream(layout, cfg, flat, residual, key, pods,
                              world, readiness)
        for i in emission_order(layout, readiness):
            stream.leaf_ready(i)
        synced, new_residual = stream.finish()
    else:
        synced, new_residual = sync_flat(flat, layout.bounds, cfg, residual,
                                         key, pods, world)
    out = unbucketize([synced], layout)
    return (unflatten(grads, out) if is_dict else out), new_residual
