"""Bucketed gradient-sync engine over stacked peers (counterpart of
``repro.collectives.engine``).

``sync_gradients`` flattens the peers' gradient leaves into an
(N, total) f32 stack, slices it into fused buckets, and runs the
backend resolved from ``SyncConfig.mode`` once per bucket: O(ceil(total
bytes / bucket_bytes)) launches per step.  This is the barrier path of
the JAX engine; its ``lax.scan`` over full buckets is a Python loop
here, bit-exact with it since the per-bucket math is the same.

A per-step sync key (``prng``) is split into one key per bucket, as
the JAX engine splits it; only the photonic noise draws from it.

Error feedback (beyond the paper) is a per-peer f32 residual over the
concatenated-leaf space, (N, total): it is added to the gradient stack
before quantization and replaced by each peer's quantization error.
A checkpoint stores it in the JAX package's layout (``residuals_to_jax``
and ``residuals_from_jax``, the one place that maps the two), and with
``SyncConfig.sparse_residuals`` block-sparsely (``pack_residuals``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from ..photonics.config import PhotonicsConfig
from ..tree import leaves as tree_leaves
from ..tree import unflatten
from . import backends  # noqa: F401  (registers psum and optinc)
from .bucketizer import DEFAULT_BUCKET_BYTES, make_layout, unbucketize
from .registry import get_backend

# what SyncConfig still rejects, and the later slice that brings it
_LATER = {
    "overlap": "streaming overlap (the overlap slice)",
    "error_layers": "Table-II error injection (the error-model slice)",
    "ring": "the ring backend (the ring/cascade slice)",
    "cascade": "the cascade backend (the ring/cascade slice)",
}


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "optinc"            # psum | optinc
    # the JAX mesh axes to sync over; the port's peers are one stacked
    # dimension, so this only keeps a JAX spec's sync object whole
    axes: tuple = ("data",)
    bits: int = 8                    # OptINC gradient bit width B
    block: int = 2048                # quantization block size (0 = global)
    error_layers: tuple = ()         # Table II key; () = ideal ONN only
    error_feedback: bool = False     # beyond-paper residual accumulation
    bucket_bytes: int = DEFAULT_BUCKET_BYTES  # fused-bucket wire payload
    overlap: bool = False            # streaming dispatch: not ported
    # checkpoint the residuals block-sparsely (only the blocks with a
    # nonzero carry; pack_residuals), the runtime state stays dense
    sparse_residuals: bool = False
    # emulation fidelity of the optinc backend: behavioral | onn (the
    # trained dense ONN inside the collective) | mesh (its MZI meshes)
    photonics: PhotonicsConfig = PhotonicsConfig()

    def __post_init__(self):
        for field, bad in (("overlap", self.overlap),
                           ("error_layers", bool(self.error_layers))):
            if bad:
                raise NotImplementedError(
                    f"SyncConfig.{field}={getattr(self, field)!r}: "
                    f"{_LATER[field]} is not ported yet")
        if self.mode in _LATER:
            raise NotImplementedError(
                f"--sync {self.mode}: {_LATER[self.mode]} is not ported yet")
        get_backend(self.mode)
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
        if ph.fidelity != "behavioral" and self.mode != "optinc":
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
# The port keeps {"rep": (N, total)}, one row a peer.  The JAX package
# keeps {"rep": (N * total,), "fsdp": (0,)}: device d's local residual is
# slice d of "rep" (sharded over 'data'), and "fsdp" is the empty FSDP
# leaf group.  Row-major flattening maps one onto the other.

def residuals_to_jax(state: dict) -> dict:
    """The port's sync state in the JAX layout (views, no copy)."""
    if not state:
        return {}
    rep = state["rep"]
    return {"rep": rep.reshape(-1), "fsdp": rep.new_zeros((0,))}


def residuals_from_jax(state: dict, peers: int) -> dict:
    """A JAX-layout sync state (tensors) as the port's (peers, total)
    rows; the FSDP group must be empty (FSDP is not ported)."""
    if not state:
        return {}
    fsdp = state.get("fsdp")
    if fsdp is not None and fsdp.numel():
        raise ValueError(f"the checkpoint holds {fsdp.numel()} FSDP "
                         f"residuals; FSDP is not ported")
    rep = state["rep"]
    if rep.ndim != 1 or rep.numel() % peers:
        raise ValueError(f"residual vector of shape {tuple(rep.shape)} does "
                         f"not split over {peers} peers")
    return {"rep": rep.reshape(peers, -1)}


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


def sync_flat(flat: torch.Tensor, bounds, cfg: SyncConfig,
              residual: torch.Tensor | None = None, key=None):
    """Sync an (N, total) f32 gradient stack bucket by bucket.

    ``bounds``: the layout's (start, end) bucket slices; ``key``: the
    step's sync key (``prng``), split into one key a bucket.  Returns
    ``(synced, new_residual)``: the (total,) average every peer
    receives and, when ``cfg.error_feedback`` and the backend reports a
    quantization error, the (N, total) residual for the next step (None
    otherwise)."""
    backend = get_backend(cfg.mode)
    ef = cfg.error_feedback and residual is not None
    synced = flat.new_empty(flat.shape[1])
    errs = []
    keys = ([None] * len(bounds) if key is None
            else prng.split(key, len(bounds)))
    for (s, e), k in zip(bounds, keys):
        x = flat[:, s:e]
        if ef:
            x = x + residual[:, s:e]
        synced[s:e], err = backend.sync(x, cfg, k)
        errs.append(err)
    new_residual = None
    if cfg.error_feedback and errs and all(e is not None for e in errs):
        new_residual = torch.cat(errs, dim=1)
    return synced, new_residual


def sync_gradients(grads, cfg: SyncConfig,
                   residual: torch.Tensor | None = None, key=None):
    """Synchronize (average) ``grads`` over the peers.

    ``grads``: a dict (walked in sorted-key order, like
    ``jax.tree.flatten``) or list of tensors, each with a leading peer
    dim N.  Returns ``(synced, new_residual)``: ``synced`` has the
    structure of ``grads`` without the peer dim (every peer receives
    the same average), ``new_residual`` is as ``sync_flat``'s; ``key``
    is the step's sync key."""
    is_dict = isinstance(grads, dict)
    leaves = tree_leaves(grads) if is_dict else list(grads)
    if not leaves:
        return grads, residual
    n = leaves[0].shape[0]
    layout = make_layout([(l.shape[1:], l.dtype) for l in leaves],
                         cfg.bucket_bytes)
    flat = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)
    synced, new_residual = sync_flat(flat, layout.bounds, cfg, residual,
                                     key)
    out = unbucketize([synced], layout)
    return (unflatten(grads, out) if is_dict else out), new_residual
