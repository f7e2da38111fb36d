"""PAM4 quantize-encode and Q(mean)-decode: wrappers of the CUDA kernels
in ``csrc/pam4.cu`` (counterparts of ``repro.kernels.pam4``
``pam4_quantize_encode`` and ``pam4_decode_dequantize``, with the
zero-block guard of ``repro.collectives.backends._encode``).

For CPU tensors each wrapper runs its plain version
(``ref.pam4_quantize_encode_ref`` / ``ref.pam4_decode_dequantize_ref``);
for CUDA tensors it launches the kernel or raises; any other device
raises.  Both are bit-exact with the plain versions.

The encode kernel has three forms (``csrc/pam4.cu`` says how each
works); ``encode_form`` picks one from the block size, the input's data
pointer and its row stride alone:

- ``aligned``: ``block % 4 == 0`` and every input row starts on 16 bytes
  (pointer on 16 bytes, row stride a multiple of 4 or one row): a thread
  owns 4 columns, one 16-byte load and one 16-byte store.
- ``shifted``: ``block % 4 == 0``, an input row off the 16-byte
  alignment: the same, with each thread's 4 values taken from the
  aligned vectors around them by warp shuffle.
- ``scalar``: any other block size, a thread an element.

The decode kernel has two forms; ``decode_form`` picks one from the
shape, the base's row stride and the three data pointers:

- ``aligned``: ``block % 4 == 0``, the sums and every output row on 16
  bytes (one row, or ``m % 4 == 0``), and no base or every base row on
  16 bytes: a thread owns 4 columns, one 16-byte load of sums (and of
  base) and one 16-byte store.  Every decode of the training step takes
  it.
- ``scalar``: any other case (a base view off 16 bytes among them), a
  thread an element.

``pam4_quantize_encode.forms`` and ``pam4_decode_dequantize.forms`` count
the launches of each form.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

FORMS = ("scalar", "aligned", "shifted")   # the C entries' ints

_ENCODE_ARGTYPES = ([ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _check_scale(scale: torch.Tensor, m: int, block: int, what: str):
    if block < 1:
        raise ValueError(f"{what}: block must be >= 1, got {block}")
    if scale.ndim != 1 or scale.dtype != torch.float32:
        raise TypeError(f"{what}: scale must be 1-d float32, got "
                        f"{tuple(scale.shape)} {scale.dtype}")
    if scale.shape[0] != -(-m // block):
        raise ValueError(f"{what}: {scale.shape[0]} scales for {m} "
                         f"elements in blocks of {block}")


def _on_card(what: str, *ts: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU, True when all lie on one
    CUDA device; raises otherwise."""
    if all(t.device.type == "cpu" for t in ts):
        return False
    if not (ts[0].is_cuda and all(t.device == ts[0].device for t in ts)):
        raise ValueError(f"{what} runs on CPU or one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    return True


def encode_form(rows: int, ld: int, block: int, g_ptr: int) -> str:
    """The encode kernel's form for ``rows`` input rows of stride ``ld``
    floats from device address ``g_ptr``, in blocks of ``block``."""
    if block % 4:
        return "scalar"
    if g_ptr % 16 == 0 and (rows == 1 or ld % 4 == 0):
        return "aligned"
    return "shifted"


def decode_form(rows: int, m: int, ld: int, block: int,
                base_ptr: int | None, out_ptr: int, total_ptr: int) -> str:
    """The decode kernel's form for ``rows`` output rows of ``m`` columns
    at device address ``out_ptr``, sums at ``total_ptr`` in blocks of
    ``block``, and a base of row stride ``ld`` floats at ``base_ptr``
    (None: no base)."""
    if block % 4 or total_ptr % 16 or out_ptr % 16 or (rows > 1 and m % 4):
        return "scalar"
    if base_ptr is not None and (base_ptr % 16 or (rows > 1 and ld % 4)):
        return "scalar"
    return "aligned"


def pam4_quantize_encode(g: torch.Tensor, scale: torch.Tensor, bits: int,
                         block: int) -> torch.Tensor:
    """g: (rows, m) f32 with its last dim contiguous (a strided view of
    the peer stack is fine); scale: (ceil(m / block),) f32 shared by the
    rows.  Returns int32 (rows, nblocks, block) offset-binary codes."""
    if g.ndim != 2 or g.dtype != torch.float32:
        raise TypeError(f"pam4_quantize_encode wants (rows, m) float32, "
                        f"got {tuple(g.shape)} {g.dtype}")
    rows, m = g.shape
    _check_scale(scale, m, block, "pam4_quantize_encode")
    if not 2 <= bits <= 16:
        raise ValueError(f"pam4_quantize_encode: bits {bits} not in 2..16")
    if not _on_card("pam4_quantize_encode", g, scale):
        return ref.pam4_quantize_encode_ref(g, scale, bits, block)
    if m and g.stride(1) != 1 or not scale.is_contiguous():
        raise ValueError("pam4_quantize_encode needs g's last dim and the "
                         "scales contiguous")
    nb = scale.shape[0]
    u = torch.empty((rows, nb, block), dtype=torch.int32, device=g.device)
    if rows == 0 or m == 0:
        return u.fill_(2 ** (bits - 1) - 1)
    form = encode_form(rows, g.stride(0), block, g.data_ptr())
    fn = _build.entry("pam4", "pam4_encode", _ENCODE_ARGTYPES)
    err = fn(g.device, g.data_ptr(), scale.data_ptr(), u.data_ptr(), rows,
             m, g.stride(0), nb, block, bits, FORMS.index(form),
             torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"pam4_quantize_encode kernel launch failed "
                           f"({form} form, cudaError {err})")
    pam4_quantize_encode.launches += 1
    pam4_quantize_encode.forms[form] += 1
    return u


def pam4_decode_dequantize(total: torch.Tensor, scale: torch.Tensor,
                           bits: int, n: int, m: int,
                           base: torch.Tensor | None = None) -> torch.Tensor:
    """total: contiguous (rows, nblocks * block) int32 sums of n peers'
    codes; scale: (nblocks,) f32 shared by the rows.  Returns f32
    (rows, m): Q(mean) dequantized, the pad columns dropped; with
    ``base`` ((rows, m) f32, last dim contiguous) ``base - decoded``
    rounded once, the error-feedback term."""
    if total.ndim != 2 or total.dtype != torch.int32:
        raise TypeError(f"pam4_decode_dequantize wants (rows, width) int32, "
                        f"got {tuple(total.shape)} {total.dtype}")
    rows, width = total.shape
    nb = scale.shape[0] if scale.ndim == 1 else 0
    if nb < 1 or width % nb:
        raise ValueError(f"pam4_decode_dequantize: width {width} is not a "
                         f"whole number of {nb} blocks")
    block = width // nb
    _check_scale(scale, m, block, "pam4_decode_dequantize")
    if not 2 <= bits <= 16 or n < 1:
        raise ValueError(f"pam4_decode_dequantize: bits {bits} / n {n}")
    if base is not None and (base.shape != (rows, m)
                             or base.dtype != torch.float32):
        raise ValueError(f"pam4_decode_dequantize: base must be ({rows}, "
                         f"{m}) float32, got {tuple(base.shape)} "
                         f"{base.dtype}")
    ts = (total, scale) if base is None else (total, scale, base)
    if not _on_card("pam4_decode_dequantize", *ts):
        return ref.pam4_decode_dequantize_ref(total, scale, bits, n, m, base)
    if not (total.is_contiguous() and scale.is_contiguous()) or (
            base is not None and m and base.stride(1) != 1):
        raise ValueError("pam4_decode_dequantize needs contiguous inputs")
    out = torch.empty((rows, m), dtype=torch.float32, device=total.device)
    if rows == 0 or m == 0:
        return out
    ld = 0 if base is None else base.stride(0)
    base_ptr = None if base is None else base.data_ptr()
    form = decode_form(rows, m, ld, block, base_ptr, out.data_ptr(),
                       total.data_ptr())
    fn = _build.entry("pam4", "pam4_decode", _DECODE_ARGTYPES)
    err = fn(total.device, total.data_ptr(), scale.data_ptr(), base_ptr,
             out.data_ptr(), rows, m, ld, nb, block, bits, n,
             FORMS.index(form),
             torch.cuda.current_stream(total.device).cuda_stream)
    if err:
        raise RuntimeError(f"pam4_decode_dequantize kernel launch failed "
                           f"({form} form, cudaError {err})")
    pam4_decode_dequantize.launches += 1
    pam4_decode_dequantize.forms[form] += 1
    return out


pam4_quantize_encode.launches = 0
pam4_quantize_encode.forms = dict.fromkeys(FORMS, 0)
pam4_decode_dequantize.launches = 0
pam4_decode_dequantize.forms = dict.fromkeys(FORMS[:2], 0)
