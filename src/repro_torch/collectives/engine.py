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
"""
from __future__ import annotations

import dataclasses

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
    "sparse_residuals": "block-sparse residual checkpoints (the "
                        "checkpoint slice)",
    "error_layers": "Table-II error injection (the error-model slice)",
    "ring": "the ring backend (the ring/cascade slice)",
    "cascade": "the cascade backend (the ring/cascade slice)",
}


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "optinc"            # psum | optinc
    bits: int = 8                    # OptINC gradient bit width B
    block: int = 2048                # quantization block size (0 = global)
    error_layers: tuple = ()         # Table II key; () = ideal ONN only
    error_feedback: bool = False     # beyond-paper residual accumulation
    bucket_bytes: int = DEFAULT_BUCKET_BYTES  # fused-bucket wire payload
    overlap: bool = False            # streaming dispatch: not ported
    sparse_residuals: bool = False   # sparse checkpoints: not ported
    # emulation fidelity of the optinc backend: behavioral | onn (the
    # trained dense ONN inside the collective) | mesh (its MZI meshes)
    photonics: PhotonicsConfig = PhotonicsConfig()

    def __post_init__(self):
        for field, bad in (("overlap", self.overlap),
                           ("sparse_residuals", self.sparse_residuals),
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
