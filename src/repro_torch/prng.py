"""The port's random keys: the tree of ``jax.random`` keys that the JAX
package threads through a training step, with integers for keys.

A key is a non-negative integer below 2^64.  ``fold_in`` and ``split``
derive child keys with a fixed integer hash (splitmix64's finalizer),
computed on the host, so a key names the same numbers in every process
and on every device.  The numbers themselves come from a
``torch.Generator`` on the tensor's device, seeded from the key
(``generator``, ``normal``); a kernel that draws its own numbers gets
uint32 seeds taken from a key (``bits32``).

The tree is the JAX package's (``api/session.py``, ``collectives/
engine.py`` and ``backends.py``, ``photonics/pipeline.py`` and
``mesh.py``): ``PRNGKey(seed + 1)`` for a run, ``fold_in(base, step)``
per step, ``split(key, n_buckets)`` per bucket, ``fold_in(key, 1)`` for
the photonic noise, ``fold_in(key, i)`` per pipeline stage and per ONN
layer, and ``split(key)`` where JAX splits (the V and U meshes of an SVD
layer, the blocks of a stacked mesh, the theta and shot terms).  So
every bucket, stage, layer, block and term draws its own numbers.  They
are not threefry's numbers: a test that holds the port against JAX feeds
JAX's draws to the port's arithmetic.
"""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
# domain words, so that fold_in(k, i), split(k, n)[i] and the key of a
# seed never coincide
_FOLD, _SPLIT, _SEED = 0x5851F42D4C957F2D, 0x14057B7EF767814F, 0xD1B54A32D192ED03


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def _child(key: int, domain: int, data: int) -> int:
    return _mix64((_mix64(key ^ domain) + (data + 1) * _GOLDEN) & _M64)


def PRNGKey(seed: int) -> int:
    """The key of an integer seed."""
    return _child(0, _SEED, int(seed) & _M64)


def fold_in(key: int, data: int) -> int:
    """The child key of ``key`` for the integer ``data``."""
    return _child(key, _FOLD, int(data) & _M64)


def split(key: int, num: int = 2) -> list:
    """``num`` child keys of ``key``, none equal to a ``fold_in`` child."""
    return [_child(key, _SPLIT, i) for i in range(num)]


def bits32(key: int, num: int) -> list:
    """``num`` uint32 words of ``key`` (kernel seeds)."""
    return [k >> 32 for k in split(key, num)]


def generator(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``key``."""
    return torch.Generator(device=torch.device(device)).manual_seed(key)


def normal(key: int, shape, dtype=torch.float32, device="cpu"
           ) -> torch.Tensor:
    """Standard normals of ``shape`` drawn on ``device`` from ``key``."""
    return torch.randn(tuple(shape), generator=generator(key, device),
                       dtype=dtype, device=device)
