"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (counterpart of
``repro.kernels.paged_attention.paged_attention``).

One pending query per slot attends over that slot's pages of the shared
KV pool in place — no contiguous copy of the cache.  For a CPU tensor the
wrapper runs the plain version (``ref.paged_attention_ref``, the gather
path); for a CUDA tensor it launches the kernel or raises; any other
device raises.  There is no platform switch and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
    pages; nothing reads either."""
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"paged_attention wants q (b, h, 1, hd), got "
                         f"{tuple(q.shape)}")
    b, h, _, hd = q.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention pools must be (P, hkv, page, hd)"
                         f" and equal: {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    _, hkv, ps, _ = k_pool.shape
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
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"paged_attention runs on CPU or one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    out = torch.empty_like(q)
    fn = _build.entry("paged_attention", "paged_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, hkv, ps, hd, page_table.shape[1],
             hd ** -0.5, _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
