"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (counterpart of
``repro.kernels.paged_attention.paged_attention``).

One pending query per slot attends over that slot's pages of the shared
KV pool in place — no contiguous copy of the cache.  A contiguous cache
(b, hkv, S, hd) is such a pool too, b pages of S positions with the
table ``arange(b)[:, None]`` (``models.blocks.gqa_decode``; ``plan``
then gives one split of the whole row).  For a CPU tensor the
wrapper runs the plain version (``ref.paged_attention_ref``, the gather
path); for a CUDA tensor it launches the kernel or raises; any other
device raises.  There is no platform switch and no fallback.

The kernel splits each slot's pages (flash-decoding; the source says
how).  ``plan`` picks the launch from the shapes and the pools' alignment
alone (never from the lengths, which live on the device):

- ``split``: positions a block walks, a whole number of pages.  Each
  (slot, kv head) gets ``ceil(nb * page / split)`` blocks, enough for
  about ``WAVE_BLOCKS`` blocks an SM over the batch, but at least
  ``MIN_SPLIT`` positions and at most the whole table.  Splits that
  start at or past a slot's length exit at once; the others are merged
  by a second small kernel (``split_ranges`` is the rule).
- ``vec_bytes``: the bytes a lane loads of a K or V row, 16 where the
  row and the pools allow, else 8, 4 or 2; a row takes ``group`` lanes
  (a power of two at most 32), so a row is at most 32 such chunks.
- ``rows``: query rows a block (1, 2 or 4); the ``rep = h / hkv`` rows of
  one kv head share each K/V load in blocks of ``rows``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build, ref

H100_SMS = 132
WAVE_BLOCKS = 2      # blocks an SM the split aims for over the batch
MIN_SPLIT = 32       # positions a split walks at least
MAX_ROWS = 4         # query rows a block
GRID_YZ_MAX = 65_535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call: ``n_splits`` splits of ``split`` positions, lanes of
    ``group`` loading ``vec_bytes`` of a row each, ``rows`` query rows a
    block in ``row_chunks`` blocks a kv head; the split kernel's grid."""
    split: int
    n_splits: int
    vec_bytes: int
    group: int
    rows: int
    row_chunks: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, hkv: int, ps: int, hd: int, nb: int,
         itemsize: int, align: int = 16, sms: int = H100_SMS) -> Plan:
    """The launch for b slots of h query heads over pools of (P, hkv, ps,
    hd) elements of ``itemsize`` bytes and page tables of nb pages, the
    pools' data pointers aligned to ``align`` bytes, on a card of
    ``sms`` multiprocessors."""
    if min(b, h, hkv, ps, hd, nb) < 1 or h % hkv:
        raise ValueError(f"paged_attention plan: bad shape b={b} h={h} "
                         f"hkv={hkv} page={ps} hd={hd} nb={nb}")
    row_bytes = hd * itemsize
    vec = next((w for w in (16, 8, 4, 2)
                if w >= itemsize and row_bytes % w == 0 and align % w == 0
                and row_bytes // w <= 32), None)
    if vec is None:
        raise ValueError(f"paged_attention: a K/V row of {hd} x {itemsize} "
                         f"bytes (pools aligned to {align}) is not at most "
                         f"32 lane chunks of 2-16 bytes")
    group = 1 << (row_bytes // vec - 1).bit_length()
    rep = h // hkv
    rows = min(1 << (rep - 1).bit_length(), MAX_ROWS)
    row_chunks = -(-rep // rows)
    if b > GRID_YZ_MAX or hkv * row_chunks > GRID_YZ_MAX:
        raise ValueError(f"paged_attention: grid of {b} slots x "
                         f"{hkv * row_chunks} head blocks is too large")
    want = -(-WAVE_BLOCKS * sms // (b * hkv * row_chunks))
    pages = min(nb, max(-(-nb // want), -(-MIN_SPLIT // ps)))
    n_splits = -(-nb // pages)
    return Plan(pages * ps, n_splits, vec, group, rows, row_chunks,
                (n_splits, hkv * row_chunks, b))


def split_ranges(length: int, nb: int, ps: int, split: int) -> list:
    """The (start, end) positions each block of a slot walks: the slot's
    length clamped to the table, cut every ``split`` positions; splits at
    or past the length are empty and skipped."""
    n = min(max(length, 0), nb * ps)
    return [(s, min(s + split, n)) for s in range(0, n, split)]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked(q, k_pool, v_pool, page_table, lengths):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"paged_attention wants q (b, h, 1, hd), got "
                         f"{tuple(q.shape)}")
    b, h, _, hd = q.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention pools must be (P, hkv, page, hd)"
                         f" and equal: {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    hkv = k_pool.shape[1]
    if k_pool.shape[3] != hd or h % hkv:
        raise ValueError(f"paged_attention head mismatch: q {tuple(q.shape)}"
                         f", pool {tuple(k_pool.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention wants page_table (b, nb) and "
                         f"lengths (b,) for b={b}, got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if (q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES
            or v_pool.dtype != k_pool.dtype):
        raise TypeError(f"paged_attention takes f32/bf16 q and one f32/bf16 "
                        f"pool dtype: {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_attention page_table/lengths must be int32, "
                        f"got {page_table.dtype}, {lengths.dtype}")


def _on_card_plan(q, k_pool, v_pool, page_table, lengths) -> Plan:
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"paged_attention runs on CPU or one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    b, h, _, hd = q.shape
    _, hkv, ps, _ = k_pool.shape
    align = math.gcd(k_pool.data_ptr(), v_pool.data_ptr(), 16)
    return plan(b, h, hkv, ps, hd, page_table.shape[1],
                k_pool.element_size(), align, _sms(q.device.index))


def _launch(q, k_pool, v_pool, page_table, lengths, p: Plan):
    b, h, _, hd = q.shape
    _, hkv, ps, _ = k_pool.shape
    out = torch.empty_like(q)
    part = (torch.empty(b * h * p.n_splits * (hd + 2), dtype=torch.float32,
                        device=q.device) if p.n_splits > 1 else None)
    fn = _build.entry("paged_attention", "paged_attention_fwd", _ARGTYPES)
    err = fn(q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(),
             b, h, hkv, ps, hd, page_table.shape[1], hd ** -0.5,
             _DTYPES[q.dtype], _DTYPES[k_pool.dtype], p.split, p.n_splits,
             p.vec_bytes, p.rows, torch.cuda.current_stream(q.device)
             .cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err}, {p})")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention for a packed slot batch, read straight off the
    physical page pool.

    q: (b, h, 1, hd) one pending query per slot, f32 or bf16;
    k_pool/v_pool: (P, hkv, page, hd) shared pages, f32 or bf16 (one
    dtype; accumulation is f32); page_table: (b, nb) int32 page ids in
    logical-block order (null page 0 beyond a slot's allocation);
    lengths: (b,) int32 valid cache positions per slot, the pending
    token's KV already written.  Positions >= length get zero weight.
    Returns (b, h, 1, hd) in q.dtype.  A slot of length 0 is a pad row:
    the kernel writes zeros there, the plain version the mean of its
    pages; nothing reads either.  On the card a K/V row must fit 32 lane
    chunks (hd * itemsize <= 512 bytes at 16-byte loads)."""
    _checked(q, k_pool, v_pool, page_table, lengths)
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    out = _launch(*tensors, _on_card_plan(*tensors))
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_with(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, split: int) -> torch.Tensor:
    """The decode on CUDA tensors with ``split`` positions a split (a
    multiple of the page size) instead of the plan's, to time splits
    against each other on the card (``chip_smoke.py``).  Not counted in
    ``paged_attention.launches``: the model's path calls
    ``paged_attention``."""
    _checked(q, k_pool, v_pool, page_table, lengths)
    tensors = (q, k_pool, v_pool, page_table, lengths)
    p = _on_card_plan(*tensors)
    n_splits = -(-page_table.shape[1] * k_pool.shape[2] // split)
    return _launch(*tensors, dataclasses.replace(
        p, split=split, n_splits=n_splits,
        grid=(n_splits,) + p.grid[1:]))
