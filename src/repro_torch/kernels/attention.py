"""Flash attention: wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (forward, counterpart of
``repro.kernels.attention.flash_attention``, GQA-aware like
``repro.models.layers.blocked_attention``) and
``csrc/flash_attention_bwd.cu`` (backward), and ``FlashAttention``, the
autograd function that joins them for training.

For CPU tensors each wrapper runs its plain version
(``ref.attention_fwd_ref`` / ``ref.attention_bwd_ref``); for CUDA
tensors it launches the kernel or raises; any other device raises.

The V head dim may differ from the QK one (deepseek-v3's MLA: QK 192 =
128 + 64 rope dims, V 128): Q, K, dQ and dK are hd wide, V, O, dO and
dV hdv wide, and the kernels are instantiated for the (hd, hdv) pairs
of ``_HEAD_DIMS``.

Each takes ``causal``: True masks query row r to key columns c <= r +
(skv - sq) (the decoder; skv >= sq), False lets every row see every
column < skv, with any sq and skv (whisper's encoder self-attention
and the decoder's cross-attention, the Pallas kernel's
``causal=False``).  Each wrapper counts its launches (``launches``),
by (hd, hdv) pair in ``launches_by_dims`` and by mask in
``launches_by_mode`` ("causal" or "full").
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (QK head dim, V head dim) pairs instantiated in flash_attention.cu and
# flash_attention_bwd.cu: the equal dims (80: qwen3_32b's 5120 / 64;
# 112: zamba2_7b's 3584 / 32), and MLA's at deepseek-v3's published
# widths (192, 128) and its SMOKE config (24, 16)
_HEAD_DIMS = ((16, 16), (32, 32), (48, 48), (64, 64), (80, 80), (112, 112),
              (128, 128), (192, 128), (24, 16))
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])


_MAX_ROW_STRIDE = 1 << 24   # elements; flash_mma.cuh kMaxRowStride


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself if the bf16 kernels can copy its rows by 16-byte loads
    (data pointer and batch, head and row strides 16-byte aligned, row
    stride below 2^24 elements), else a contiguous copy of it."""
    item = t.element_size()
    if (t.data_ptr() % 16 == 0 and t.stride(2) < _MAX_ROW_STRIDE
            and all(s * item % 16 == 0 for s in t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False, causal: bool = True):
    """Multi-head GQA attention.  q: (b, h, sq, hd); k: (b, hkv,
    skv, hd), v: (b, hkv, skv, hdv) with h a multiple of hkv; the scale
    is hd^-0.5; f32 or bf16, all one dtype; each
    tensor's last dimension contiguous (other strides are free, so
    transposed views need no copy).  Causal: query row r sees key
    columns c <= r + (skv - sq), which needs skv >= sq; not causal:
    every column.  Returns (b, h, sq, hdv) in q.dtype, and
    with ``return_lse`` also the per-row log-sum-exp of the scaled scores
    (b, h, sq) f32, which the backward needs.  bf16 runs on the tensor
    cores, whose kernel reads rows by 16-byte copies: a view whose rows
    are not 16-byte aligned (or lie 2^24 elements apart or more) is
    copied first."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants 4-d q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    hkv, skv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape != (b, hkv, skv, hd) or v.shape != (b, hkv, skv, hdv)
            or hkv < 1 or h % hkv):
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and skv < sq:
        raise ValueError(f"causal flash_attention needs skv >= sq "
                         f"(got sq={sq}, skv={skv})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16, one dtype: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        out, lse = ref.attention_fwd_ref(q, k, v, causal)
        return (out, lse) if return_lse else out
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention runs on CPU or one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if (hd, hdv) not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel (QK, V) head dims are "
                         f"{_HEAD_DIMS}, got {(hd, hdv)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs each last dim contiguous")
    if q.dtype == torch.bfloat16:
        q, k, v = (_kernel_rows(t) for t in (q, k, v))
    out = torch.empty((b, h, sq, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr() if return_lse else None,
             b, h, hkv, sq, skv, hd, hdv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             hd ** -0.5, _DTYPES[q.dtype], int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {err})")
    _count(flash_attention, hd, hdv, causal)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention`` given its output o,
    its log-sum-exp lse and the output gradient do.  q/k/v and
    ``causal`` as the forward took them; do: (b, h, sq, hdv) with its
    last dim contiguous;
    o: contiguous (b, h, sq, hdv), lse: contiguous (b, h, sq) f32.
    Returns dq (b, h, sq, hd), dk (b, hkv, skv, hd) and dv (b, hkv,
    skv, hdv), contiguous, in the input dtype.  Deterministic: no atomics.  bf16 runs on the
    tensor cores and copies views its kernels cannot read in place, as
    the forward does."""
    b, h, sq, hd = q.shape
    hkv, skv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    if (o.shape != (b, h, sq, hdv) or do.shape != o.shape
            or lse.shape != (b, h, sq) or k.shape != (b, hkv, skv, hd)
            or v.shape != (b, hkv, skv, hdv) or h % hkv
            or (causal and skv < sq)):
        raise ValueError(f"flash_attention_bwd shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, o {tuple(o.shape)}, lse "
                         f"{tuple(lse.shape)}, do {tuple(do.shape)}")
    if (q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do))
            or lse.dtype != torch.float32):
        raise TypeError(f"flash_attention_bwd takes f32 or bf16 tensors of "
                        f"one dtype and an f32 lse, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}, {o.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    ts = (q, k, v, o, lse, do)
    if all(t.device.type == "cpu" for t in ts):
        return ref.attention_bwd_ref(q, k, v, o, lse, do, causal)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError(f"flash_attention_bwd runs on CPU or one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if (hd, hdv) not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel (QK, V) head dims "
                         f"are {_HEAD_DIMS}, got {(hd, hdv)}")
    if any(t.stride(-1) != 1 for t in (q, k, v, do)) or not (
            o.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd needs q/k/v/do last dims "
                         "contiguous and o, lse contiguous")
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = (_kernel_rows(t) for t in (q, k, v, o, do))
    dq = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, hkv, skv, hdv), dtype=q.dtype, device=q.device)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd",
                      _BWD_ARGTYPES)
    err = fn(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), do.data_ptr(), dsum.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv,
             hd, hdv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *do.stride()[:3], hd ** -0.5, _DTYPES[q.dtype], int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed "
                           f"(cudaError {err})")
    _count(flash_attention_bwd, hd, hdv, causal)
    return dq, dk, dv


def _count(fn, hd: int, hdv: int, causal: bool) -> None:
    """One launch of ``fn``: its total, its (hd, hdv) pair and its mask."""
    fn.launches += 1
    key = f"{hd}x{hdv}"
    fn.launches_by_dims[key] = fn.launches_by_dims.get(key, 0) + 1
    mode = "causal" if causal else "full"
    fn.launches_by_mode[mode] = fn.launches_by_mode.get(mode, 0) + 1


for _fn in (flash_attention, flash_attention_bwd):
    _fn.launches = 0
    _fn.launches_by_dims = {}
    _fn.launches_by_mode = {}


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward runs the forward
    kernel and, when a gradient is needed, keeps its output and
    log-sum-exp; the backward runs ``flash_attention_bwd`` (the backward
    kernel on the card, ``ref.attention_bwd_ref`` on the CPU) with the
    same mask.  Without a gradient (serving, ``torch.no_grad``) the
    forward writes no lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        if not any(ctx.needs_input_grad):
            return flash_attention(q, k, v, causal=causal)
        out, lse = flash_attention(q, k, v, return_lse=True, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.causal),
                None)
