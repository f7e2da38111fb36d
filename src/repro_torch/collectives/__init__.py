"""Bucket-fused gradient synchronization of the port (counterpart of
``repro.collectives``) for data-parallel peers stacked on one card.

The JAX package runs one program per device inside shard_map and syncs
over the mesh's 'data' axis.  Here the N peers of that axis are a
leading peer dimension of size N on one device: each peer's gradient is
one row of an (N, elements) stack, the fabric's integer sum is a sum
over that dimension (exact in int32), and the shared block scale is a
max over it.  ``--mesh Nx1`` means N data-parallel peers in both
packages; ``--pods P --mesh Nx1`` means P pods of N peers, a (P, N)
peer grid.

All of it is ported: ``bucketizer`` (layout, flatten, (un)bucketize,
the streaming segments and launch order), ``registry``, ``backends``
(psum, ring, optinc and the two-level cascade, at fidelities
'behavioral', 'onn' and 'mesh', with Table-II error injection) and
``engine`` (SyncConfig, the barrier and streaming ``sync_gradients``
with error-feedback residuals, ``BucketStream`` for the trainer's
overlap, the residuals' checkpoint layout and block-sparse packing)."""
from .engine import (BucketStream, SyncConfig, is_packed_residuals,
                     pack_residuals, residuals_from_jax, residuals_to_jax,
                     sync_gradients, unpack_residuals)
from .registry import available_backends, get_backend, register_backend
