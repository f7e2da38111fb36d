"""The dense ONN layer ``y = act(d * (x W^T) + b)``: wrapper of the CUDA
kernel in ``csrc/onn_layer.cu`` (counterpart of
``repro.kernels.onn_layer.onn_layer``).

Every dense layer of the in-network ONN (``photonics.onn.apply``) runs
through it.  For CPU tensors the wrapper runs the plain version
(``ref.onn_layer_ref``); for CUDA tensors it launches the kernel or
raises; any other device raises.  The caller pads nothing: any rows, n
and m.

The kernel has forms for the layer's shape (``csrc/onn_layer.cu`` says
how each works).  ``plan`` picks one from the shape and the alignment of
x and y alone, and sizes its tile, grid and shared memory; a CUDA call
launches exactly that form once.  Every form sums each output in the same
order, so they give the same bits.

- ``wide``: n and m above ``NARROW`` and multiples of 4, x and y 16-byte
  aligned, and W's panel fits in shared memory (n up to 288 at 128
  columns, 416 at 64).  Persistent blocks, W's panel resident, x by a
  cp.async ring.
- ``fan_out``: n at most ``NARROW``; a thread owns 4 output columns (m
  a multiple of 4 up to ``4 * THREADS``, y aligned: 4 -> 64, 1 -> 4) or
  one (m up to ``THREADS``: 4 -> 1).
- ``fan_in``: m at most ``NARROW``, n a multiple of 4, x aligned
  (64 -> 4), while W and the ring fit.
- ``general``: every other shape or alignment, the simple tiled product.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

THREADS = 256              # threads a block, every form
SMEM_MAX = 232_448         # dynamic shared memory a block may use (H100)
SMEM_SM = 233_472          # shared memory of an SM; 1 KB of it a block
H100_SMS = 132
NARROW = 8                 # n or m up to this: a fan form
WIDE_BK, WIDE_STAGES = 32, 3   # k of a chunk, chunks of the wide ring
FAN_OUT_BLOCKS_SM = 8      # resident 256-thread blocks an SM
FAN_IN_STAGES = 4
FAN_IN_STAGE_BYTES = 32 << 10   # at most this much x a ring stage
GRID_X_MAX = 2 ** 31 - 1
GRID_Y_MAX = 65_535
FORMS = ("general", "wide", "fan_out", "fan_in")   # the C entry's ints

_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the form, its tile (``wide``: W's panel columns, with
    row tiles of ``wide_rows(tile)``; ``fan_in``: rows a ring stage;
    ``fan_out``: columns a thread; ``general``: rows of a block tile),
    the grid (x, y), threads a block and dynamic shared memory in
    bytes."""
    form: str
    tile: int
    grid: tuple
    threads: int
    smem: int


def wide_rows(bn: int) -> int:
    """Rows of the wide form's row tile for a panel of bn columns: a
    thread keeps 8 rows x 8 columns at bn 128, 16 x 4 at bn 64."""
    return 128 if bn == 128 else 256


def wide_smem(n: int, bn: int) -> int:
    """Bytes of W's panel (for each 32 k, bn rows of 36 words) and the
    ring of three chunks (csrc/onn_layer.cu wide_smem)."""
    nk = -(-n // WIDE_BK)
    return 4 * (WIDE_BK + 4) * (nk * bn + WIDE_STAGES * wide_rows(bn))


def fan_in_smem(n: int, m: int, tile: int) -> int:
    """Bytes of W, d, b and the ring at row pitch n + 4
    (csrc/onn_layer.cu fan_in_smem)."""
    return 4 * ((m + FAN_IN_STAGES * tile) * (n + 4) + 16)


def general_plan(rows: int, m: int) -> Plan:
    """The general form's launch: one block a (row tile, column tile)."""
    bm, bn = (256, 4) if m <= 8 else (128, 64) if m <= 64 else (128, 128)
    return Plan("general", bm, (-(-rows // bm), -(-m // bn)), THREADS, 0)


def _wide(rows: int, n: int, m: int, sms: int) -> Plan | None:
    widest = 128 if m > 64 else 64
    for bn in (128, 64):
        smem = wide_smem(n, bn)
        if bn <= widest and smem <= SMEM_MAX:
            col_tiles = -(-m // bn)
            per_col = max(1, min(-(-rows // wide_rows(bn)),
                                 sms // col_tiles))
            return Plan("wide", bn, (per_col, col_tiles), THREADS, smem)
    return None


def _fan_out(rows: int, m: int, y16: bool, sms: int) -> Plan | None:
    if m % 4 == 0 and m <= 4 * THREADS and y16:
        cpt = 4
    elif m <= THREADS:
        cpt = 1
    else:
        return None
    groups = m // cpt
    per_pass = THREADS // groups
    blocks = min(-(-rows // per_pass), sms * FAN_OUT_BLOCKS_SM)
    return Plan("fan_out", cpt, (blocks, 1), per_pass * groups, 0)


def _fan_in(rows: int, n: int, m: int, sms: int) -> Plan | None:
    tile = max(1, min(-(-THREADS // m),
                      FAN_IN_STAGE_BYTES // (4 * (n + 4))))
    smem = fan_in_smem(n, m, tile)
    if smem > SMEM_MAX:
        return None
    per_sm = max(1, min(FAN_OUT_BLOCKS_SM, SMEM_SM // (smem + 1024)))
    blocks = min(-(-rows // tile), sms * per_sm)
    return Plan("fan_in", tile, (blocks, 1), THREADS, smem)


def plan(rows: int, n: int, m: int, x_ptr: int, y_ptr: int,
         sms: int = H100_SMS) -> Plan:
    """The launch for a (rows, n) x (m, n) layer with x and y at the
    device addresses ``x_ptr`` and ``y_ptr``, on a card of ``sms``
    multiprocessors, by the rules above."""
    if rows < 1 or n < 1 or m < 1:
        raise ValueError(f"onn_layer plan wants rows, n, m >= 1, got "
                         f"{rows}, {n}, {m}")
    x16, y16 = x_ptr % 16 == 0, y_ptr % 16 == 0
    p = None
    if n <= NARROW:
        p = _fan_out(rows, m, y16, sms)
    elif m <= NARROW:
        p = _fan_in(rows, n, m, sms) if n % 4 == 0 and x16 else None
    elif n % 4 == 0 and m % 4 == 0 and x16 and y16:
        p = _wide(rows, n, m, sms)
    return p or general_plan(rows, m)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, w, d, b, y, relu: bool, p: Plan) -> None:
    rows, n = x.shape
    fn = _build.entry("onn_layer", "onn_layer", _ARGTYPES)
    err = fn(x.device, x.data_ptr(), w.data_ptr(), d.data_ptr(),
             b.data_ptr(), y.data_ptr(), rows, n, w.shape[0], int(relu),
             FORMS.index(p.form), p.tile, p.grid[0],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"onn_layer kernel launch failed ({p.form} "
                           f"form, cudaError {err})")


def _checked(x, w, d, b):
    if (x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]
            or x.shape[1] == 0):
        raise ValueError(f"onn_layer wants x (rows, n) and w (m, n) with "
                         f"n >= 1, got {tuple(x.shape)}, {tuple(w.shape)}")
    m = w.shape[0]
    if tuple(d.shape) != (m,) or tuple(b.shape) != (m,):
        raise ValueError(f"onn_layer wants d and b of shape ({m},), got "
                         f"{tuple(d.shape)}, {tuple(b.shape)}")
    ts = (x, w, d, b)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"onn_layer takes float32 only, got "
                        f"{[str(t.dtype) for t in ts]}")


def onn_layer(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
              b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """x: (rows, n) f32; w: (m, n) f32; d, b: (m,) f32.  Returns f32
    (rows, m): ``d * (x @ w.T) + b``, then ReLU when ``relu``."""
    _checked(x, w, d, b)
    ts = (x, w, d, b)
    if all(t.device.type == "cpu" for t in ts):
        return ref.onn_layer_ref(x, w, d, b, relu)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"onn_layer runs on CPU or one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    x, w, d, b = (t.contiguous() for t in ts)
    rows, n = x.shape
    m = w.shape[0]
    y = torch.empty((rows, m), dtype=torch.float32, device=x.device)
    if rows == 0 or m == 0:
        return y
    _launch(x, w, d, b, y, relu, plan(rows, n, m, x.data_ptr(),
                                      y.data_ptr(), _sms(x.device.index)))
    onn_layer.launches += 1
    return y


onn_layer.launches = 0


def onn_layer_general(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                      b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The layer on CUDA tensors through the general form whatever the
    shape, to hold the other forms against it on the card
    (``chip_smoke.py``).  Not counted in ``onn_layer.launches``: the
    model's path calls ``onn_layer``."""
    _checked(x, w, d, b)
    if not all(t.is_cuda for t in (x, w, d, b)):
        raise ValueError("onn_layer_general runs on CUDA tensors only")
    x, w, d, b = (t.contiguous() for t in (x, w, d, b))
    y = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                    device=x.device)
    _launch(x, w, d, b, y, relu, general_plan(x.shape[0], w.shape[0]))
    return y
