"""Gradient-bucket fusion (counterpart of ``repro.collectives.bucketizer``).

Leaves are flattened to f32 and concatenated in tree order (sorted keys,
as ``jax.tree.flatten`` walks a dict), then sliced at fixed
``bucket_bytes`` boundaries: a bucket may span leaf boundaries and the
last one may be short.  The layout is static (shapes and dtypes only).

The engine applies the same layout to the peers' stacked gradients: an
(N, total) matrix whose buckets are column slices.  For the streaming
(overlap) engine the layout also answers, from shapes alone, which leaf
slices each bucket fuses and back (``bucket_segments``,
``leaf_segments``), and in which order buckets become ready when the
backward emits leaf gradients in a given order (``emission_order``,
``launch_order``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

DEFAULT_BUCKET_BYTES = 4 * 2 ** 20   # 4 MiB of f32 wire payload per bucket


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static description of how a leaf list maps onto fused buckets."""
    shapes: tuple           # per-leaf shapes
    dtypes: tuple           # per-leaf dtypes
    sizes: tuple            # per-leaf element counts
    total: int              # sum(sizes)
    bucket_elems: int       # elements per full bucket
    bounds: tuple           # per-bucket (start, end) in concat space

    @property
    def n_buckets(self) -> int:
        return len(self.bounds)


def make_layout(leaves, bucket_bytes: int = DEFAULT_BUCKET_BYTES
                ) -> BucketLayout:
    """Layout for ``leaves`` (tensors, or (shape, dtype) pairs)."""
    if bucket_bytes <= 0:
        raise ValueError(
            f"bucket_bytes must be positive, got {bucket_bytes} "
            "(a 0 --bucket-mb would mean one collective per element)")
    shapes, dtypes = [], []
    for leaf in leaves:
        shape, dtype = ((tuple(leaf.shape), leaf.dtype)
                        if isinstance(leaf, torch.Tensor) else
                        (tuple(leaf[0]), leaf[1]))
        shapes.append(shape)
        dtypes.append(dtype)
    sizes = tuple(math.prod(s) for s in shapes)
    total = sum(sizes)
    bucket_elems = max(int(bucket_bytes) // 4, 1)
    bounds = tuple((s, min(s + bucket_elems, total))
                   for s in range(0, total, bucket_elems))
    return BucketLayout(shapes=tuple(shapes), dtypes=tuple(dtypes),
                        sizes=sizes, total=total, bucket_elems=bucket_elems,
                        bounds=bounds)


def bucket_segments(layout: BucketLayout) -> tuple:
    """Per-bucket leaf coverage: one tuple a bucket of ``(leaf_idx,
    start, stop)`` triples, ``[start, stop)`` the LEAF-LOCAL flat slice
    the bucket fuses.  The triples of bucket b tile ``layout.bounds[b]``
    of the concat space; a zero-size leaf appears in no bucket."""
    segs, offsets, off = [], [], 0
    for sz in layout.sizes:
        offsets.append(off)
        off += sz
    for s, e in layout.bounds:
        cur = []
        for i, (lo, sz) in enumerate(zip(offsets, layout.sizes)):
            a, b = max(s, lo), min(e, lo + sz)
            if a < b:
                cur.append((i, a - lo, b - lo))
        segs.append(tuple(cur))
    return tuple(segs)


def leaf_segments(layout: BucketLayout) -> tuple:
    """The transpose of ``bucket_segments``: per leaf, ``(bucket_idx,
    start, stop)`` triples in bucket order, ``[start, stop)`` the
    BUCKET-LOCAL slice holding that part of the leaf.  A zero-size leaf
    gets an empty tuple."""
    per_leaf = [[] for _ in layout.sizes]
    for b, seg in enumerate(bucket_segments(layout)):
        off = 0
        for i, a, t in seg:
            per_leaf[i].append((b, off, off + (t - a)))
            off += t - a
        assert layout.bounds[b][0] + off == layout.bounds[b][1]
    return tuple(tuple(p) for p in per_leaf)


def _ranks(layout: BucketLayout, readiness) -> tuple:
    n = len(layout.sizes)
    if readiness is None:
        return tuple(n - 1 - i for i in range(n))
    if len(readiness) != n:
        raise ValueError(
            f"readiness must rank every leaf: got {len(readiness)} ranks "
            f"for {n} leaves")
    return tuple(readiness)


def emission_order(layout: BucketLayout, readiness=None) -> tuple:
    """The leaves in the order the backward emits their gradients
    (``readiness`` as in ``launch_order``, ties by descending leaf
    index): an ``engine.BucketStream`` told of the leaves in this order
    launches the buckets in ``launch_order``."""
    ranks = _ranks(layout, readiness)
    return tuple(sorted(range(len(ranks)), key=lambda i: (ranks[i], -i)))


def launch_order(layout: BucketLayout, readiness=None) -> tuple:
    """Bucket dispatch schedule for the streaming engine.

    ``readiness`` ranks each leaf by when its gradient leaves the
    backward (lower = earlier); by default the backward runs back to
    front, so ``readiness[i] = n_leaves - 1 - i``.  A bucket is ready
    when its latest leaf is; buckets go in ready order, ties broken by
    descending bucket index, so the default schedule is the reversed
    bucket order."""
    readiness = _ranks(layout, readiness)
    segs = bucket_segments(layout)
    ready = [max((readiness[i] for i, _, _ in seg), default=0)
             for seg in segs]
    return tuple(sorted(range(len(segs)), key=lambda b: (ready[b], -b)))


def flatten_concat(leaves) -> torch.Tensor:
    """Concatenate leaves (any shapes/dtypes) into one f32 vector."""
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([l.reshape(-1).float() for l in leaves])


def bucketize(leaves, layout: BucketLayout) -> list:
    """Leaves -> list of 1-D f32 buckets (the last one may be short)."""
    flat = flatten_concat(leaves)
    return [flat[s:e] for s, e in layout.bounds]


def unbucketize(buckets, layout: BucketLayout) -> list:
    """Buckets (1-D) -> leaves with the layout's shapes and dtypes.
    Exact for f32 leaves; bf16 leaves round-trip exactly too, since f32
    holds them losslessly."""
    flat = (torch.cat(list(buckets)) if len(buckets)
            else torch.zeros((0,), dtype=torch.float32))
    out, off = [], 0
    for shape, dtype, size in zip(layout.shapes, layout.dtypes, layout.sizes):
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return out


def expected_buckets(total_grad_bytes: int,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> int:
    """ceil(total_grad_bytes / bucket_bytes) in f32 elements, with the
    same floored per-bucket element count as ``make_layout``."""
    bucket_elems = max(int(bucket_bytes) // 4, 1)
    total_elems = -(-int(total_grad_bytes) // 4)
    return -(-total_elems // bucket_elems)
