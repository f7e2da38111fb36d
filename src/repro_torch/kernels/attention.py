"""Flash-attention prefill: wrapper of the CUDA kernel
``csrc/flash_attention.cu`` (counterpart of
``repro.kernels.attention.flash_attention``, GQA-aware like
``repro.models.layers.blocked_attention``).

For a CPU tensor the wrapper runs the plain version
(``ref.attention_ref``); for a CUDA tensor it launches the kernel or
raises; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 48, 64, 128)   # instantiated in flash_attention.cu
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal multi-head GQA attention.  q: (b, h, sq, hd); k/v: (b, hkv,
    skv, hd) with h a multiple of hkv; f32 or bf16, all one dtype; each
    tensor's last dimension contiguous (other strides are free, so
    transposed views need no copy).  Query row r sees key columns c <= r + (skv -
    sq), which needs skv >= sq.  Returns (b, h, sq, hd) in q.dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants 4-d q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if v.shape[-1] != hd:
        raise ValueError(f"flash_attention needs the v head dim to equal "
                         f"q's ({v.shape[-1]} != {hd}); MLA is not ported")
    if (k.shape != (b, hkv, skv, hd) or v.shape != k.shape
            or hkv < 1 or h % hkv):
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if skv < sq:
        raise ValueError(f"causal flash_attention needs skv >= sq "
                         f"(got sq={sq}, skv={skv})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16, one dtype: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.attention_ref(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention runs on CPU or one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel head dims are "
                         f"{_HEAD_DIMS}, got {hd}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs each last dim contiguous")
    out = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, h, hkv, sq, skv, hd,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             hd ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
