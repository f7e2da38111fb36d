"""Block quantization of gradients (counterpart of
``repro.photonics.encoding``, paper eq. 2-3).

A gradient block is scaled by its max-abs, rounded to a signed B-bit
integer in ``[-levels, levels]`` and stored offset-binary (``u = q +
levels``) so optical amplitudes are non-negative.  The OptINC
behavioural target is ``Q(mean)``: the integer sum over N servers,
divided by N and rounded to nearest, ties to even (``torch.round``,
like ``jnp.round``).

Only the functions the behavioral collective uses are ported; the PAM4
symbol functions (``pam4_encode`` ... ``splitter``) belong to the
``onn`` fidelity.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

F32_TINY = torch.finfo(torch.float32).tiny    # 1.1754944e-38


def num_symbols(bits: int) -> int:
    """M = ceil(B/2) PAM4 symbols per B-bit value."""
    return (bits + 1) // 2


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Block quantization spec.  ``block`` is the flattened block size;
    0 means one global scale (the paper's global block quantization)."""
    bits: int = 8
    block: int = 0

    @property
    def levels(self) -> int:
        # symmetric signed range [-levels, +levels]
        return 2 ** (self.bits - 1) - 1

    @property
    def offset(self) -> int:
        return 2 ** (self.bits - 1)


def _block_view(x: torch.Tensor, block: int) -> torch.Tensor:
    """x's elements, flattened, as (num_blocks, block) rows with the last
    row padded with zeros; block <= 0 gives one row."""
    flat = x.reshape(-1)
    if block <= 0:
        return flat.reshape(1, -1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def compute_scale(g: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Per-block max-abs scale floored at the f32 tiny, (num_blocks,)."""
    s = _block_view(g, spec.block).abs().amax(dim=1)
    return s.clamp_min(F32_TINY)


def quantize(g: torch.Tensor, spec: QuantSpec, scale=None):
    """Float gradient -> offset-binary ints in [0, 2^B - 2], g's shape,
    int32.  Returns (u, scale)."""
    g = g.float()
    if scale is None:
        scale = compute_scale(g, spec)
    blocks = _block_view(g, spec.block)
    q = torch.round(blocks / scale[:, None] * spec.levels)
    q = q.clamp(-spec.levels, spec.levels).to(torch.int32)
    u = q + spec.levels
    return u.reshape(-1)[:g.numel()].reshape(g.shape), scale


def dequantize(u: torch.Tensor, scale: torch.Tensor,
               spec: QuantSpec) -> torch.Tensor:
    blocks = _block_view(u.float() - spec.levels, spec.block)
    g = blocks * (scale[:, None] / spec.levels)
    return g.reshape(-1)[:u.numel()].reshape(u.shape)


def qmean(u_stack: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Eq. (3): Q(mean over server axis 0) in the integer domain."""
    if n is None:
        n = u_stack.shape[0]
    total = u_stack.to(torch.int32).sum(dim=0, dtype=torch.int32)
    return torch.round(total.float() / n).to(torch.int32)
