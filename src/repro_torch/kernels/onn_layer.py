"""The dense ONN layer ``y = act(d * (x W^T) + b)``: wrapper of the CUDA
kernel in ``csrc/onn_layer.cu`` (counterpart of
``repro.kernels.onn_layer.onn_layer``).

Every dense layer of the in-network ONN (``photonics.onn.apply``) runs
through it.  For CPU tensors the wrapper runs the plain version
(``ref.onn_layer_ref``); for CUDA tensors it launches the kernel or
raises; any other device raises.  The caller pads nothing: any rows, n
and m.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p])


def onn_layer(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
              b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """x: (rows, n) f32; w: (m, n) f32; d, b: (m,) f32.  Returns f32
    (rows, m): ``d * (x @ w.T) + b``, then ReLU when ``relu``."""
    if (x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]
            or x.shape[1] == 0):
        raise ValueError(f"onn_layer wants x (rows, n) and w (m, n) with "
                         f"n >= 1, got {tuple(x.shape)}, {tuple(w.shape)}")
    rows, n = x.shape
    m = w.shape[0]
    if tuple(d.shape) != (m,) or tuple(b.shape) != (m,):
        raise ValueError(f"onn_layer wants d and b of shape ({m},), got "
                         f"{tuple(d.shape)}, {tuple(b.shape)}")
    ts = (x, w, d, b)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"onn_layer takes float32 only, got "
                        f"{[str(t.dtype) for t in ts]}")
    if all(t.device.type == "cpu" for t in ts):
        return ref.onn_layer_ref(x, w, d, b, relu)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"onn_layer runs on CPU or one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    x, w, d, b = (t.contiguous() for t in ts)
    y = torch.empty((rows, m), dtype=torch.float32, device=x.device)
    if rows == 0 or m == 0:
        return y
    fn = _build.entry("onn_layer", "onn_layer", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), d.data_ptr(), b.data_ptr(),
             y.data_ptr(), rows, n, m, int(relu),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"onn_layer kernel launch failed (cudaError "
                           f"{err})")
    onn_layer.launches += 1
    return y


onn_layer.launches = 0
