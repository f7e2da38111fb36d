"""Pluggable collective-backend registry (counterpart of
``repro.collectives.registry``).

A backend owns ONE bucket's synchronization over the stacked peers plus
the analytic wire models:

  sync(x, cfg, key=None) -> (synced, local_err | None)
      ``x`` is a (*peers, elems) f32 bucket with one leading dimension a
      sync axis of ``cfg.axes``: (N, elems) over ('data',), (pods, dp,
      elems) over ('pod', 'data').  ``synced`` is the (elems,) average
      every peer receives; ``local_err`` is each peer's quantization
      error, (N, elems) with peer p = pod * dp + d, for error feedback,
      or None for exact backends.  ``key`` is the bucket's sync key
      (PhaseNoise, Table-II injection).

  bytes_on_wire(nbytes, n, bits) -> float
  time_on_wire(nbytes, n, bits, overlap=False, bucket_bytes=...) -> float
      Per-device wire bytes and seconds to synchronize ``nbytes`` of raw
      bf16 gradient across ``n`` peers; ``overlap=True`` must never
      exceed ``overlap=False``.
"""
from __future__ import annotations

_REGISTRY: dict = {}


def register_backend(name: str, backend, overwrite: bool = False):
    """Register ``backend`` (an object with sync/bytes_on_wire/
    time_on_wire) under ``name``; returns it."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"collective backend {name!r} already registered")
    for attr in ("sync", "bytes_on_wire", "time_on_wire"):
        if not callable(getattr(backend, attr, None)):
            raise TypeError(f"backend {name!r} lacks a callable {attr}()")
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sync mode {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))
