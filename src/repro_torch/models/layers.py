"""Layer primitives of the dense transformer (counterpart of
``repro.models.layers``).

The JAX module runs inside shard_map: parameters arrive as local shards,
activations are replicated over the 'model' axis, and tensor
parallelism is explicit collectives (column-parallel in-projections
need none, row-parallel out-projections and the vocab-sharded
embedding and loss close with ``lax.psum`` over 'model'; FSDP weights
are all-gathered over 'data' where they are used).  Here the same
functions take the static ``ShardCtx`` and the process mesh ``axes``
(``launch.distributed.ProcessAxes``; None for stacked peers, whose
weights are whole), and the collectives are
``models.collectives.psum_model``/``all_gather_data``/``pmax_model``,
autograd functions with JAX's ``check_vma=False`` transposes.  At tp 1
without FSDP the collectives are identities and the code is the tp-1
code.

Attention keeps the JAX names: ``blocked_attention`` is the flash
kernel with its gradient (``kernels.attention.FlashAttention``: the CUDA
forward and backward kernels for CUDA tensors, their plain versions for
CPU tensors), and
``decode_attention``/``paged_gather``, the gather decode math that only
the paged kernel's plain version uses, are defined in ``kernels.ref``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import FlashAttention
from ..kernels.ref import NEG_INF, decode_attention, paged_gather
from .collectives import all_gather_data, pmax_model, psum_model

__all__ = ["NEG_INF", "ShardCtx", "NO_SHARD", "tp_index", "gather_fsdp",
           "rmsnorm", "rope", "embed_lookup", "lm_loss",
           "blocked_attention", "decode_attention", "swiglu_mlp",
           "update_cache", "paged_update_cache", "paged_gather"]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static sharding context threaded through the model code (JAX's
    fields).  ``seq_parallel`` is held only so a spec can ask for it:
    sequence parallelism is refused (``api.spec``)."""
    tp: int = 1                   # size of 'model' axis
    dp: int = 1                   # size of 'data' axis
    pods: int = 1                 # size of 'pod' axis (1 = single pod)
    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: str = "pod"
    fsdp: bool = False            # params sharded over data axis
    seq_shard_cache: bool = False  # decode KV cache sharded over data axis
    seq_parallel: bool = False    # refused: see api.spec
    remat_groups: int = 0         # nested-remat group count (0 = none)

    @property
    def dp_axes(self) -> tuple:
        return (self.pod_axis, self.data_axis) if self.pods > 1 else (
            self.data_axis,)

    @property
    def sharded(self) -> bool:
        """Whether any parameter is a shard (tp > 1 or FSDP)."""
        return self.tp > 1 or self.fsdp


NO_SHARD = ShardCtx()


def tp_index(ctx: ShardCtx, axes) -> int:
    """This rank's index on the 'model' axis (0 without processes)."""
    return 0 if axes is None else axes.axis_index(ctx.model_axis)


def gather_fsdp(ctx: ShardCtx, axes, w: torch.Tensor,
                axis: int) -> torch.Tensor:
    """All-gather an FSDP-sharded weight along ``axis`` over 'data' (the
    identity without FSDP, and for stacked peers, whose weights are
    whole); the backward reduce-scatters the gradient (ZeRO-3)."""
    if not ctx.fsdp:
        return w
    return all_gather_data(w, axes, axis)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., t, h, hd), pos: (t,) or (b, t)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (..., t, hd/2)
    ang = ang[..., None, :]                                # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(emb: torch.Tensor, ids: torch.Tensor,
                 ctx: ShardCtx = NO_SHARD, axes=None) -> torch.Tensor:
    """Vocab-sharded embedding lookup: emb (V_local, d) is this rank's
    vocabulary shard; rows of ids outside it are zero, and the psum over
    'model' joins the shards.  At tp 1 the plain lookup."""
    if ctx.tp == 1:
        return F.embedding(ids, emb)
    v_local = emb.shape[0]
    lo = tp_index(ctx, axes) * v_local
    x = F.embedding((ids - lo).clamp(0, v_local - 1), emb)
    mask = ((ids >= lo) & (ids < lo + v_local))[..., None]
    x = torch.where(mask, x, torch.zeros((), dtype=emb.dtype,
                                         device=emb.device))
    return psum_model(x, axes)


LOSS_CHUNK = 1024          # JAX's lm_loss chunk


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               mask, ctx: ShardCtx, axes) -> torch.Tensor:
    """The NLL of one sequence chunk, f32: the mean over its tokens, or
    with ``mask`` (b, t) 0/1 the masked mean sum(nll * mask) /
    max(sum(mask), 1)."""
    logits = (x @ head).float()                        # (b, t, V_local)
    m = pmax_model(logits.detach().amax(dim=-1), axes)  # stability shift
    sumexp = psum_model(torch.exp(logits - m[..., None]).sum(dim=-1), axes)
    lse = torch.log(sumexp) + m
    if ctx.tp == 1:
        tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    else:
        v_local = head.shape[-1]
        lo = tp_index(ctx, axes) * v_local
        local_t = (targets.long() - lo).clamp(0, v_local - 1)
        tgt = logits.gather(-1, local_t[..., None])[..., 0]
        in_shard = (targets >= lo) & (targets < lo + v_local)
        tgt = psum_model(torch.where(in_shard, tgt, torch.zeros(
            (), dtype=tgt.dtype, device=tgt.device)), axes)
    nll = lse - tgt
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def lm_loss(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
            ctx: ShardCtx = NO_SHARD, axes=None,
            chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Vocab-sharded cross-entropy (JAX's ``lm_loss``): x (b, t, d), head
    (d, V_local) this rank's vocabulary shard, targets (b, t) global
    token ids.  Returns the mean NLL, f32: the stability shift is the
    pmax over 'model' of the detached logits' max, the log-sum-exp and
    the target logit (where it lies in this shard, else 0) are psummed
    over 'model'.  At t > ``chunk`` the sequence is padded to a multiple
    of ``chunk`` with a 0/1 mask and taken a chunk at a time under
    ``torch.utils.checkpoint``, so only one chunk's (b, chunk, V_local)
    f32 logits are live, in the forward and in the backward; the chunks'
    masked means are summed as JAX's scan sums them, acc + mean * count
    in f32 (one FMA, as XLA compiles it), and the total divided by the
    count."""
    t = x.shape[1]
    if t <= chunk:
        return _chunk_nll(x, head, targets, None, ctx, axes)
    pad = (-t) % chunk
    mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[1], chunk):
        sl = slice(lo, lo + chunk)
        mean = checkpoint(_chunk_nll, x[:, sl], head, targets[:, sl],
                          mask[:, sl], ctx, axes, use_reentrant=False)
        n = mask[:, sl].sum()
        tot = _FMA.apply(mean, n, tot)
        cnt = cnt + n
    return tot / cnt.clamp_min(1.0)


def fma_round_once(a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, for f32 tensors, with no branch and
    no read by the host: the product is exact in f64, the f64 sum s is
    rounded to odd (stepped to its odd neighbour toward the exact sum
    where the TwoSum error is not 0 and s is even), and a value rounded
    to odd with 29 bits to spare rounds to f32 as the exact sum does."""
    ab = a.double() * b.double()
    cd = c.double()
    s = ab + cd
    bb = s - ab
    err = (ab - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


class _FMA(torch.autograd.Function):
    """``fma_round_once`` with the gradient of a * b + c."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return fma_round_once(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """GQA attention with a gradient, through the flash kernels; causal,
    or with ``causal=False`` every query over every key (any sq, skv).
    q: (b, h, sq, hd), k/v: (b, hkv, skv, hd), last dims contiguous."""
    return FlashAttention.apply(q, k, v, causal)


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down,
               ctx: ShardCtx = NO_SHARD, axes=None) -> torch.Tensor:
    """Column/row-parallel SwiGLU.  w_gate/w_up: (d, ff_local) local
    shards, w_down: (ff_local, d) (FSDP shards gathered here); ends with
    the psum over 'model'."""
    g = x @ gather_fsdp(ctx, axes, w_gate, 0)
    u = x @ gather_fsdp(ctx, axes, w_up, 0)
    h = F.silu(g.float()).to(x.dtype) * u
    return psum_model(h @ gather_fsdp(ctx, axes, w_down, 1), axes)


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Write one decode step's K or V into the contiguous cache at
    position ``pos``, IN PLACE (JAX's ``update_cache``, whose new cache
    replaces the donated one).  cache: (b, hkv, S, hd), new: (b, hkv, 1,
    hd).  The sequence-sharded cache (``ctx.seq_shard_cache``) is not
    ported."""
    if ctx.seq_shard_cache:
        raise NotImplementedError("update_cache: the seq-sharded cache "
                                  "(seq_shard_cache) is not ported")
    cache[:, :, pos] = new[:, :, 0].to(cache.dtype)
    return cache


# -------------------------- paged KV cache ---------------------------

def paged_update_cache(pool: torch.Tensor, new: torch.Tensor, page_ids,
                       offsets) -> torch.Tensor:
    """Write one decode step's K or V for a packed slot batch into a paged
    pool, IN PLACE (the JAX version returns a new pool and relies on
    buffer donation to avoid the copy).  pool: (P, hkv, page, hd);
    new: (b, hkv, 1, hd); page_ids/offsets: (b,) each slot's target page
    and in-page offset.  Inactive slot rows point at the reserved null
    page 0, whose contents are never read as valid."""
    pool[page_ids, :, offsets, :] = new[:, :, 0, :].to(pool.dtype)
    return pool
