"""Bucket-fused gradient synchronization of the port (counterpart of
``repro.collectives``) for data-parallel peers stacked on one card.

The JAX package runs one program per device inside shard_map and syncs
over the mesh's 'data' axis.  Here the N peers of that axis are a
leading peer dimension of size N on one device: each peer's gradient is
one row of an (N, elements) stack, the fabric's integer sum is a sum
over that dimension (exact in int32), and the shared block scale is a
max over it.  ``--mesh Nx1`` means N data-parallel peers in both
packages.

Ported: ``bucketizer`` (layout, flatten, (un)bucketize), ``registry``,
``backends`` (psum, and optinc at fidelities 'behavioral' and 'onn')
and ``engine`` (SyncConfig, the barrier ``sync_gradients`` with
error-feedback residuals, their checkpoint layout and block-sparse
packing)."""
from .engine import (SyncConfig, is_packed_residuals, pack_residuals,
                     residuals_from_jax, residuals_to_jax, sync_gradients,
                     unpack_residuals)
from .registry import available_backends, get_backend, register_backend
