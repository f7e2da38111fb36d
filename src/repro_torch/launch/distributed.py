"""Data-parallel peers as processes, one per card (counterpart of the
``shard_map`` programs of ``repro.launch.steps``).

The JAX step runs one program per device of the ('pod', 'data') mesh,
and every gradient sync there is a collective between devices.  Here a
run launched with one process per peer does the same over
``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors
(chosen by the run's device, not as a fallback).

A run is in process mode when its launch environment says so, as JAX's
device count comes from its launch: ``torchrun`` (``python -m
torch.distributed.run``) sets ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` (``launched``).  ``init`` binds the process to card
``LOCAL_RANK`` before any CUDA work, builds the CUDA kernels once (local
rank 0, then a barrier), starts the process group with a timeout of
minutes (a rank that dies fails the others instead of hanging them) and
returns the ranks as a ``(pods, dp)`` device mesh with the axis names of
``mesh``: rank = peer = pod * dp + d.

``ProcessAxes`` offers the ``lax`` collectives the JAX backends call,
each over one or more named axes: ``axis_size``, ``axis_index``,
``pmax``, ``psum``, ``psum_scatter``, ``all_gather`` and ``ppermute``
(plus the gathers, broadcast and stop flag of the trainer).  It counts
the bytes it hands to each collective by op and dtype (``bytes``): a
reduce-scatter's input, an all-gather's output, an all-reduce's or a
ppermute's buffer, so the count over a sync is its full-length tensor.

JAX reduce-scatters the B-bit codes in int16 when the sum fits (2^B -
2) * N < 2^15.  NCCL has no 16-bit integer type and gloo refuses int16,
so ``psum_scatter(..., lanes16=True)`` packs two codes in each int32
(``pack_lanes``: the low lane the first half of a shard, the high lane
the second): a lane's sum stays below 2^15, so it never carries into
the other, and the wire moves 2 bytes a code as JAX's int16 does.
"""
from __future__ import annotations

import collections
import datetime
import os
import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import AXIS_NAMES

TIMEOUT = datetime.timedelta(minutes=5)
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")

_WORLD = None     # the ProcessAxes of this process, once initialized


def launched() -> bool:
    """True when the launch environment names this process a rank."""
    return all(k in os.environ for k in LAUNCH_ENV)


def world_size() -> int:
    return int(os.environ["WORLD_SIZE"])


def local_rank() -> int:
    return int(os.environ["LOCAL_RANK"])


def pack_lanes(rows: torch.Tensor) -> torch.Tensor:
    """(k, s) non-negative int32 codes below 2^15 -> (k, ceil(s / 2))
    int32: the first half of each row in the low 16 bits, the second
    half (zero-padded) in the high 16."""
    h = -(-rows.shape[1] // 2)
    rows = F.pad(rows, (0, 2 * h - rows.shape[1]))
    return rows[:, :h] | (rows[:, h:] << 16)


def unpack_lanes(packed: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of ``pack_lanes`` for one (h,) row (of sums whose
    lanes are below 2^16): the s int32 codes."""
    return torch.cat([packed & 0xFFFF, packed >> 16])[:s]


def _tag(op: str, t: torch.Tensor) -> str:
    return f"{op}:{str(t.dtype).removeprefix('torch.')}"


class ProcessAxes:
    """The ``lax`` collectives over the named axes of a (pod, data) mesh
    of processes.  Every method is collective: each rank of the axes'
    groups calls it, in the same order."""

    def __init__(self, mesh, device: torch.device):
        self.mesh = mesh
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.bytes = collections.Counter()      # "op:dtype" -> bytes

    def _count(self, op: str, t: torch.Tensor) -> None:
        self.bytes[_tag(op, t)] += t.numel() * t.element_size()

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(ax for ax in axes if self.sizes[ax] > 1)

    def axis_size(self, axes) -> int:
        n = 1
        for ax in ((axes,) if isinstance(axes, str) else axes):
            n *= self.sizes[ax]
        return n

    def axis_index(self, ax: str) -> int:
        return self.mesh.get_local_rank(ax)

    def _all_reduce(self, op: str, x: torch.Tensor, axes, red):
        out = x.clone()
        for ax in self._axes(axes):
            self._count(op, out)
            dist.all_reduce(out, op=red, group=self.mesh.get_group(ax))
        return out

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce("pmax", x, axes, dist.ReduceOp.MAX)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce("psum", x, axes, dist.ReduceOp.SUM)

    def psum_scatter(self, x: torch.Tensor, ax: str,
                     lanes16: bool = False) -> torch.Tensor:
        """Tiled reduce-scatter of the 1-D x (k * s elements, k the axis
        size) over ``ax``: this rank's (s,) shard of the sum, shard i to
        the rank of axis index i.  ``lanes16``: int32 codes whose sums
        stay below 2^15 go two in a word (``pack_lanes``)."""
        k = self.sizes[ax]
        if k == 1:
            return x
        s = x.numel() // k
        send = pack_lanes(x.view(k, s)).reshape(-1) if lanes16 else x
        out = send.new_empty(send.numel() // k)
        self._count("psum_scatter", send)
        dist.reduce_scatter_tensor(out, send.contiguous(),
                                   group=self.mesh.get_group(ax))
        return unpack_lanes(out, s) if lanes16 else out

    def all_gather(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        """Tiled all-gather of the 1-D x over ``ax``, in axis order.  A
        16-bit tensor goes as its bytes (an all-gather does no
        arithmetic, and NCCL has no uint16)."""
        k = self.sizes[ax]
        if k == 1:
            return x
        send = x.view(torch.uint8) if x.dtype == torch.uint16 else x
        out = send.new_empty(send.numel() * k)
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, send.contiguous(),
                                    group=self.mesh.get_group(ax))
        return out.view(x.dtype)

    def ppermute(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        """JAX's ``ppermute`` with pairs (i, i + 1 mod k) over ``ax``:
        x goes to the next rank of the axis, the previous rank's comes
        back; one ``batch_isend_irecv``, addressed by global rank."""
        k = self.sizes[ax]
        if k == 1:
            return x
        group = self.mesh.get_group(ax)
        i = self.axis_index(ax)
        out = torch.empty_like(x)
        self._count("ppermute", x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(),
                       dist.get_global_rank(group, (i + 1) % k), group),
            dist.P2POp(dist.irecv, out,
                       dist.get_global_rank(group, (i - 1) % k), group)])
        for r in reqs:
            r.wait()
        return out

    # ------------------------------------------ the trainer's collectives
    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (1, ...) x as (N, ...) in rank order (peer p =
        pod * dp + d), on every rank."""
        out = x.new_empty((self.size, *x.shape[1:]))
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(self.pmax(t, AXIS_NAMES).item())

    def broadcast_(self, tensors) -> None:
        """Rank 0's values into ``tensors`` on every rank, in place."""
        for t in tensors:
            self._count("broadcast", t)
            dist.broadcast(t, src=0)

    def barrier(self) -> None:
        dist.barrier()


def _check_cards() -> None:
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise RuntimeError(
            f"{ranks} CUDA ranks on a machine with {cards} card(s): peers "
            f"as processes take one card each (NCCL refuses two ranks on "
            f"one card); run --device cpu for gloo ranks")


def init(pods: int, dp: int, device, timeout=TIMEOUT) -> ProcessAxes:
    """This process's rank of the (pods, dp) mesh of processes, started
    once (later calls return it).  ``device``: a CUDA device (this
    rank's card, ``cuda:LOCAL_RANK``; NCCL) or the CPU (gloo)."""
    global _WORLD
    if _WORLD is not None:
        have = tuple(_WORLD.sizes.values())
        if have != (pods, dp):
            raise ValueError(f"the process group is a {have} mesh, not "
                             f"({pods}, {dp})")
        return _WORLD
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if n != pods * dp:
        raise ValueError(f"WORLD_SIZE {n} != pods * dp = {pods} * {dp}: "
                         f"one process a peer")
    device = torch.device(device)
    if device.type == "cuda":
        _check_cards()
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", timeout=timeout, device_id=device)
        if local_rank() == 0:
            from ..kernels import _build
            _build.build()
        dist.barrier()
    else:
        dist.init_process_group("gloo", timeout=timeout)
    mesh = init_device_mesh(device.type, (pods, dp), mesh_dim_names=AXIS_NAMES)
    _WORLD = ProcessAxes(mesh, device)
    return _WORLD


def shutdown() -> None:
    """End the process group (at the end of a run), every rank past a
    barrier first."""
    global _WORLD
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _WORLD = None


def exit_rank(code: int) -> None:
    """Leave a launched rank's process with ``code`` once its output is
    flushed, without the interpreter's teardown: with gloo groups (torch
    2.13, CPU) that teardown aborted 2 to 8 of 48 exits of 2-rank runs
    ("terminate called without an active exception") after all their
    work was done, destroyed groups or not, and none with this."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
