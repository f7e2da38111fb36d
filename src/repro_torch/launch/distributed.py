"""Peers as processes, one per card, over a (pod, data, model) mesh
(counterpart of the ``shard_map`` programs of ``repro.launch.steps``).

The JAX step runs one program per device of the ('pod', 'data',
'model') mesh, and every collective there is between devices.  Here a
run launched with one process per device does the same over
``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors
(chosen by the run's device, not as a fallback).

A run is in process mode when its launch environment says so, as JAX's
device count comes from its launch: ``torchrun`` (``python -m
torch.distributed.run``) sets ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` (``launched``).  ``init`` binds the process to card
``LOCAL_RANK`` before any CUDA work, builds the CUDA kernels once (local
rank 0, then a barrier), starts the process group with a timeout of
minutes (a rank that dies fails the others instead of hanging them) and
returns the ranks as a ``(pods, dp, tp)`` device mesh with the axis
names of ``mesh``, in JAX's device order: rank = (pod * dp + d) * tp + m.

``ProcessAxes`` offers the ``lax`` collectives the JAX code calls, each
over one or more named axes: ``axis_size``, ``axis_index``, ``pmax``,
``psum``, ``psum_scatter``, ``all_gather`` and ``ppermute`` (plus the
gathers, broadcast and stop flag of the trainer; a checkpoint's leaves
go to rank 0 alone, ``gather_to_root``).  It counts the bytes
it hands to each collective by op and dtype (``bytes``) and by axis,
op and dtype (``axis_bytes``, "axis/op:dtype"; the trainer's whole-world
collectives under "world"): a reduce-scatter's input, an all-gather's
output, an all-reduce's or a ppermute's buffer, so the count over a
sync is its full-length tensor.

Inside the model (tensor parallelism and FSDP) the collectives of a
ProcessAxes are called through the autograd functions of
``models.collectives``.

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

from .mesh import AXIS_NAMES, coords_of

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
    """The ``lax`` collectives over the named axes of a (pod, data,
    model) mesh of processes.  Every method is collective: each rank of
    the axes' groups calls it, in the same order."""

    def __init__(self, mesh, device: torch.device):
        self.mesh = mesh
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.bytes = collections.Counter()      # "op:dtype" -> bytes
        self.axis_bytes = collections.Counter()  # "axis/op:dtype" -> bytes

    @property
    def coords(self) -> tuple:
        """(pod, d, m): this rank's place in the mesh."""
        return coords_of(self.rank, self.sizes["data"], self.sizes["model"])

    def _count(self, op: str, t: torch.Tensor, ax: str = "world") -> None:
        n = t.numel() * t.element_size()
        self.bytes[_tag(op, t)] += n
        self.axis_bytes[f"{ax}/{_tag(op, t)}"] += n

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
            self._count(op, out, ax)
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
        self._count("psum_scatter", send, ax)
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
        self._count("all_gather", out, ax)
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
        self._count("ppermute", x, ax)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(),
                       dist.get_global_rank(group, (i + 1) % k), group),
            dist.P2POp(dist.irecv, out,
                       dist.get_global_rank(group, (i - 1) % k), group)])
        for r in reqs:
            r.wait()
        return out

    def all_gather_dim(self, x: torch.Tensor, ax: str,
                       dim: int) -> torch.Tensor:
        """Tiled all-gather of x along ``dim`` over ``ax`` (JAX's
        ``all_gather(..., axis=dim, tiled=True)``), in axis order."""
        k = self.sizes[ax]
        if k == 1:
            return x
        send = x.movedim(dim, 0).contiguous()
        out = send.new_empty((k * send.shape[0], *send.shape[1:]))
        self._count("all_gather", out, ax)
        dist.all_gather_into_tensor(out, send, group=self.mesh.get_group(ax))
        return out.movedim(0, dim).contiguous()

    def psum_scatter_dim(self, x: torch.Tensor, ax: str,
                         dim: int) -> torch.Tensor:
        """Tiled reduce-scatter sum of x along ``dim`` over ``ax`` (JAX's
        ``psum_scatter(..., scatter_dimension=dim, tiled=True)``), in
        x's dtype: shard i of the sum to the rank of axis index i."""
        k = self.sizes[ax]
        if k == 1:
            return x
        send = x.movedim(dim, 0).contiguous()
        out = send.new_empty((send.shape[0] // k, *send.shape[1:]))
        self._count("psum_scatter", send, ax)
        dist.reduce_scatter_tensor(out, send, group=self.mesh.get_group(ax))
        return out.movedim(0, dim).contiguous()

    # ------------------------------------------ the trainer's collectives
    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (1, ...) x as (N, ...) in rank order, on every
        rank (a bf16 x goes as its bits)."""
        send = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
        out = send.new_empty((self.size, *send.shape[1:]))
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, send.contiguous())
        return out.view(x.dtype)

    def gather_to_root(self, x: torch.Tensor):
        """Every rank's x (one shape on every rank) as (N, *x.shape) in
        rank order on rank 0's host, None on the other ranks, which only
        send (a bf16 x goes as its bits).  Each rank counts the bytes it
        hands over."""
        if self.size == 1:
            return x.detach().to("cpu", copy=True)[None]
        send = x.detach().reshape(-1).contiguous()
        send = send.view(torch.uint8) if x.dtype == torch.bfloat16 else send
        self._count("gather", send)
        parts = ([torch.empty_like(send) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(send, parts, dst=0)
        if parts is None:
            return None
        return torch.stack([p.cpu() for p in parts]).view(x.dtype).reshape(
            self.size, *x.shape)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (an all-reduce
        over the whole world)."""
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


def init(pods: int, dp: int, tp: int, device,
         timeout=TIMEOUT) -> ProcessAxes:
    """This process's rank of the (pods, dp, tp) mesh of processes,
    started once (later calls return it).  ``device``: a CUDA device
    (this rank's card, ``cuda:LOCAL_RANK``; NCCL) or the CPU (gloo)."""
    global _WORLD
    if _WORLD is not None:
        have = tuple(_WORLD.sizes.values())
        if have != (pods, dp, tp):
            raise ValueError(f"the process group is a {have} mesh, not "
                             f"({pods}, {dp}, {tp})")
        return _WORLD
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if n != pods * dp * tp:
        raise ValueError(f"WORLD_SIZE {n} != pods * dp * tp = {pods} * "
                         f"{dp} * {tp}: one process a device")
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
    mesh = init_device_mesh(device.type, (pods, dp, tp),
                            mesh_dim_names=AXIS_NAMES)
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
