"""The MZI-mesh cascade: wrapper of the CUDA kernel in
``csrc/mesh_scan.cu`` (counterpart of ``repro.kernels.mesh_scan``).

``mesh_scan_blocks`` applies B stacked rotation-layer programs (the
(B, L, m) ``perm``/``ca``/``sa`` stacks of ``photonics.mesh``) in one
launch; ``mesh_scan`` is its B = 1 case and counts its launches there.
Every rotation mesh of the in-network ONN at fidelity 'mesh' runs
through it, whichever ``mesh_backend`` is asked for.  For CPU tensors the
wrapper runs the plain version (``ref.mesh_scan_blocks_ref``); for CUDA
tensors it launches the kernel (float32 only) or raises; any other
device raises.

The kernel keeps whole rows in registers: a lane holds ``lane_wires(m)``
adjacent wires of ``warp_rows(m)`` rows, and a partner's value comes
from the neighbouring wire or lane, so it takes only programs whose
partners are neighbours and pair up, one alignment of pairs a layer
(``check_program``: what Givens programming on adjacent planes gives);
the wrapper refuses any other on every device.  It checks a program
once: it holds the ``perm`` and ``sa`` of the last ``_CHECKED_MAX``
programs checked (1 MiB a program at m 256, L 509; at most 64 MiB of
such programs), so that their memory is not reused, under their
addresses, shape and version counters.  A program
changed in place through ``.data``, which counts no version, is not
checked again: that is not supported.  The inputs must be finite: at a
wire with no partner the kernel adds 0 times a neighbour, which is NaN
where that neighbour is infinite and the plain version keeps the wire.

``mesh_scan_blocks.launches`` counts the kernel's launches and
``mesh_scan_blocks.branches`` splits them into those without and with
the theta drift ("clean", "theta_drift").

``blk_b`` is the rows one CUDA block holds (0 = the default,
``DEFAULT_WARPS`` warps): a multiple of 8 of at most ``MAX_WARPS`` warps
of ``warp_rows(m)`` rows, clamped to the rows given rounded up to 8, as
the JAX kernel clamps its batch tile.  The plain version has no tile,
but the wrapper checks ``blk_b`` on every device alike.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build, ref

MAX_WARPS = 8         # warps a CUDA block may have
DEFAULT_WARPS = 4     # warps of the default row tile
MAX_WIRES = 1024      # 32 lanes of at most 32 wires

_ARGTYPES = ([ctypes.c_void_p] * 8
             + [ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_CHECKED_MAX = 64
_checked: collections.OrderedDict = collections.OrderedDict()


def lane_wires(m: int) -> int:
    """Adjacent wires a lane holds: m / 32 rounded up to a power of 2."""
    return 1 << max(0, -(-m // 32) - 1).bit_length()


def warp_rows(m: int) -> int:
    """Rows a warp holds in registers for a mesh of width m: 16, or
    128 / lane_wires(m) above 8 wires a lane (csrc/mesh_scan.cu
    warp_rows)."""
    w = lane_wires(m)
    return 16 if w <= 8 else 128 // w


def row_tile(m: int, rows: int, blk_b: int = 0) -> int:
    """The rows a CUDA block holds for a mesh of width m: ``blk_b`` (or
    the default tile), clamped to ``rows`` rounded up to 8.  Raises on a
    ``blk_b`` the kernel cannot take."""
    if blk_b < 0 or blk_b % 8:
        raise ValueError(f"mesh_scan: blk_b must be a multiple of 8 (0 = "
                         f"default), got {blk_b}")
    most = MAX_WARPS * warp_rows(m)
    if blk_b > most:
        raise ValueError(
            f"mesh_scan: blk_b={blk_b} rows of {m} wires need "
            f"{-(-blk_b // warp_rows(m))} warps of {warp_rows(m)} rows, more "
            f"than the {MAX_WARPS} a block may have (at most {most} rows)")
    tile = blk_b or DEFAULT_WARPS * warp_rows(m)
    return min(tile, -(-max(rows, 1) // 8) * 8)


def check_program(perm: torch.Tensor, sa: torch.Tensor) -> None:
    """Raise ValueError unless every partner is a neighbour (perm[w] in
    {w - 1, w, w + 1}, inside 0 .. m - 1), partners pair up (perm is an
    involution), every wire with no partner (perm[w] = w) has sa = 0 and
    no layer pairs both even-aligned wires (2i, 2i + 1) and odd-aligned
    ones (2i + 1, 2i + 2): what the kernel relies on.  ``perm`` and
    ``sa`` are (..., L, m)."""
    m = perm.shape[-1]
    wire = torch.arange(m, device=perm.device)
    step = perm.long() - wire
    far = (step.abs() > 1) | (perm < 0) | (perm >= m)
    if bool(far.any()):
        raise ValueError(f"mesh_scan: every partner must be a neighbouring "
                         f"wire (perm[w] in w-1, w, w+1), but "
                         f"{int(far.sum())} of the program's entries are not")
    unpaired = perm.long().gather(-1, perm.long()) != wire
    if bool(unpaired.any()):
        raise ValueError(f"mesh_scan: partners must pair up (perm[perm[w]] "
                         f"= w), but {int(unpaired.sum())} do not")
    alone = (step == 0) & (sa != 0)
    if bool(alone.any()):
        raise ValueError(f"mesh_scan: a wire with no partner (perm[w] = w) "
                         f"must have sa = 0, but {int(alone.sum())} have not")
    lower = (step == 1) & (wire % 2 == 0), (step == 1) & (wire % 2 == 1)
    mixed = lower[0].any(-1) & lower[1].any(-1)
    if bool(mixed.any()):
        raise ValueError(f"mesh_scan: a layer must pair only even-aligned "
                         f"wires (2i, 2i + 1) or only odd-aligned ones (2i + "
                         f"1, 2i + 2), but {int(mixed.sum())} layers mix "
                         f"them")


def _check_once(perm, sa):
    """``check_program`` once per program (see the module docstring)."""
    key = (perm.device, tuple(perm.shape),
           *((t.data_ptr(), t._version) for t in (perm, sa)))
    if key in _checked:
        _checked.move_to_end(key)
        return
    check_program(perm, sa)
    _checked[key] = (perm, sa)
    if len(_checked) > _CHECKED_MAX:
        _checked.popitem(last=False)


def _check(signs, perm, ca, sa, x, x_block_axis, post_scale, seeds,
           theta_std):
    if perm.ndim != 3 or perm.dtype != torch.int32:
        raise TypeError(f"mesh_scan: perm must be (B, L, m) int32, got "
                        f"{tuple(perm.shape)} {perm.dtype}")
    n_blocks, n_layers, m = perm.shape
    if not (0 < m <= MAX_WIRES and n_layers > 0 and n_blocks > 0):
        raise ValueError(f"mesh_scan: perm shape {tuple(perm.shape)} wants "
                         f"B, L >= 1 and 1 <= m <= {MAX_WIRES}")
    floats = {"signs": signs, "ca": ca, "sa": sa, "x": x}
    if post_scale is not None:
        floats["post_scale"] = post_scale
    want = {"signs": (n_blocks, m), "ca": (n_blocks, n_layers, m),
            "sa": (n_blocks, n_layers, m), "post_scale": (n_blocks, m)}
    for name, t in floats.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"mesh_scan: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if (x.ndim < 1 + x_block_axis or x.shape[-1] != m
            or (x_block_axis and x.shape[-2] != n_blocks)):
        want_x = f"(..., {n_blocks}, {m})" if x_block_axis else f"(..., {m})"
        raise ValueError(f"mesh_scan: x must be {want_x}, got "
                         f"{tuple(x.shape)}")
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or dtypes & {torch.float32, torch.float64} != dtypes:
        raise TypeError(f"mesh_scan: x, signs, ca, sa and post_scale must "
                        f"share float32 (or float64 on the CPU), got "
                        f"{ {k: str(t.dtype) for k, t in floats.items()} }")
    tensors = dict(floats, perm=perm)
    if theta_std > 0.0:
        if seeds is None:
            raise ValueError("mesh_scan_blocks: theta_std > 0 needs "
                             "per-block uint32 seeds")
        if (tuple(seeds.shape) != (n_blocks,) or seeds.is_floating_point()
                or seeds.is_complex()):
            raise ValueError(f"mesh_scan: seeds must be ({n_blocks},) "
                             f"integers, got {tuple(seeds.shape)} "
                             f"{seeds.dtype}")
        tensors["seeds"] = seeds
    bad = [k for k, t in tensors.items() if not t.is_contiguous()]
    if bad:
        raise ValueError(f"mesh_scan: {bad} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"mesh_scan runs on CPU or one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"mesh_scan runs on CPU or CUDA, got {device}")
    if device.type == "cuda" and x.dtype != torch.float32:
        raise TypeError(f"mesh_scan: the CUDA kernel takes float32 only, "
                        f"got {x.dtype}")
    return device


def mesh_scan_blocks(signs: torch.Tensor, perm: torch.Tensor,
                     ca: torch.Tensor, sa: torch.Tensor, x: torch.Tensor, *,
                     x_block_axis: bool = False, transpose: bool = False,
                     post_scale: torch.Tensor | None = None, blk_b: int = 0,
                     theta_std: float = 0.0,
                     seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Apply B stacked rotation-layer programs in one launch.

    ``signs`` (B, m); ``perm`` (B, L, m) int32, ``ca``/``sa`` (B, L, m);
    ``x`` shared by the blocks, (..., m), or with its own block axis at
    -2 (``x_block_axis``), (..., B, m); returns (..., B, m): o_b @ x (o_b^T
    with ``transpose``) times ``post_scale`` (B, m) when given.
    ``theta_std`` > 0 turns on the theta drift, seeded per block from
    ``seeds`` (B,) uint32.  All tensors contiguous, on one device; the
    program one ``check_program`` takes, and the values finite."""
    device = _check(signs, perm, ca, sa, x, x_block_axis, post_scale, seeds,
                    theta_std)
    n_blocks, n_layers, m = perm.shape
    batch_shape = x.shape[:-2] if x_block_axis else x.shape[:-1]
    rows = batch_shape.numel()
    tile = row_tile(m, rows, blk_b)
    _check_once(perm, sa)
    if device.type == "cpu":
        return ref.mesh_scan_blocks_ref(
            signs, perm, ca, sa, x, x_block_axis=x_block_axis,
            transpose=transpose, post_scale=post_scale, theta_std=theta_std,
            seeds=seeds)
    out = torch.empty(batch_shape + (n_blocks, m), dtype=torch.float32,
                      device=device)
    if rows == 0:
        return out
    seed_ptr = None
    if theta_std > 0.0:
        s = seeds.to(torch.int64) & 0xFFFFFFFF
        seeds = torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)
        seed_ptr = seeds.data_ptr()        # read by the kernel as uint32
    fn = _build.entry("mesh_scan", "mesh_scan_blocks", _ARGTYPES)
    err = fn(x.device, x.data_ptr(), signs.data_ptr(), perm.data_ptr(),
             ca.data_ptr(), sa.data_ptr(),
             None if post_scale is None else post_scale.data_ptr(),
             seed_ptr, out.data_ptr(), rows, n_blocks, n_layers, m,
             int(x_block_axis), int(transpose), float(theta_std), tile,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"mesh_scan_blocks kernel launch failed "
                           f"(cudaError {err})")
    mesh_scan_blocks.launches += 1
    mesh_scan_blocks.branches["theta_drift" if theta_std > 0.0
                              else "clean"] += 1
    return out


mesh_scan_blocks.launches = 0
mesh_scan_blocks.branches = {"clean": 0, "theta_drift": 0}


def mesh_scan(signs: torch.Tensor, perm: torch.Tensor, ca: torch.Tensor,
              sa: torch.Tensor, x: torch.Tensor, transpose: bool = False,
              post_scale: torch.Tensor | None = None, blk_b: int = 0,
              theta_std: float = 0.0,
              seed: torch.Tensor | None = None) -> torch.Tensor:
    """One compiled rotation-layer stack ((L, m) ``perm``/``ca``/``sa``,
    (m,) ``signs``) applied to ``x`` (..., m): the B = 1 case of
    ``mesh_scan_blocks``, whose launch count it adds to."""
    out = mesh_scan_blocks(
        signs[None], perm[None], ca[None], sa[None], x, transpose=transpose,
        post_scale=None if post_scale is None else post_scale[None],
        blk_b=blk_b, theta_std=theta_std,
        seeds=None if seed is None else seed.reshape(1))
    return out[..., 0, :]
