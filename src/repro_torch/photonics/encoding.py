"""PAM4 gradient encoding/decoding and block quantization (counterpart of
``repro.photonics.encoding``, paper eq. 2-3).

A gradient block is scaled by its max-abs, rounded to a signed B-bit
integer in ``[-levels, levels]`` and stored offset-binary (``u = q +
levels``) so optical amplitudes are non-negative.  A B-bit code ``u`` is
carried as ``M = ceil(B/2)`` PAM4 symbols of 2 bits each (eq. 2),

    I^(i) = floor(u / 4^(M-i)) mod 4,   i = 1..M   (i = 1 the MSB symbol).

The OptINC behavioural target is ``Q(mean)`` (eq. 3): the integer sum
over N servers, divided by N and rounded to nearest, ties to even
(``torch.round``, like ``jnp.round``).  The preprocessing unit P merges
each group of ``g = ceil(M/K)`` consecutive symbols into one base-4
value, the K inputs of the in-network ONN.

Every function computes what its JAX namesake computes, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

F32_TINY = torch.finfo(torch.float32).tiny    # 1.1754944e-38


def f32_reciprocal(c: float) -> float:
    """The f32 reciprocal of c, correctly rounded, as a Python float: what
    compiled JAX multiplies by where the code divides by the constant c
    (XLA's rewrite; the jnp reductions such as ``mean`` are compiled
    even when called eagerly)."""
    return float(np.float32(1.0) / np.float32(c))


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


def pam4_encode(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Offset-binary ints -> PAM4 symbols, appended axis of size M (eq.
    2).  Symbol 0 is the most significant (the paper's i = 1)."""
    m = num_symbols(bits)
    shifts = torch.arange(m - 1, -1, -1, dtype=torch.int32, device=u.device)
    sym = torch.div(u[..., None], 4 ** shifts, rounding_mode="floor") % 4
    return sym.to(torch.int32)


def pam4_decode(sym: torch.Tensor) -> torch.Tensor:
    """PAM4 symbols (last axis = M, MSB first) -> offset-binary ints."""
    m = sym.shape[-1]
    weights = 4 ** torch.arange(m - 1, -1, -1, dtype=torch.int32,
                                device=sym.device)
    return (sym.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def expected_avg_symbols(sym_stack: torch.Tensor, bits: int) -> torch.Tensor:
    """Servers' PAM4 symbols (N, ..., M) -> symbols of Q(mean): the ONN's
    exact behavioural target."""
    return pam4_encode(qmean(pam4_decode(sym_stack)), bits)


# ------------------------- preprocessing unit P -------------------------

def preprocess_group_size(bits: int, k: int) -> int:
    """g = ceil(M/K): number of PAM4 symbols merged per ONN input."""
    return math.ceil(num_symbols(bits) / k)


def group_symbols(sym: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Unit P grouping of ONE symbol stream: each group of g consecutive
    PAM4 symbols becomes one base-4 value.  sym: (..., M) -> (..., K)
    int32 values in [0, 4^g - 1]; the first group is zero-padded on its
    MSB side when K g > M."""
    g = preprocess_group_size(bits, k)
    pad = k * g - sym.shape[-1]
    if pad:
        sym = torch.cat([sym.new_zeros(sym.shape[:-1] + (pad,)), sym], -1)
    grouped = sym.to(torch.int32).reshape(sym.shape[:-1] + (k, g))
    w = 4 ** torch.arange(g - 1, -1, -1, dtype=torch.int32,
                          device=sym.device)
    return (grouped * w).sum(dim=-1, dtype=torch.int32)


def preprocess(sym_stack: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Unit P (paper III-A): group each server's symbols and average over
    the N servers, the sum times f32(1/N) as ``jnp.mean`` computes it.
    sym_stack: (N, ..., M) -> A: (..., K) f32 in [0, 4^g - 1], step
    1/N."""
    vals = group_symbols(sym_stack, bits, k).float()
    return vals.sum(dim=0) * f32_reciprocal(vals.shape[0])


def _weighted_sum(x: torch.Tensor, weights) -> torch.Tensor:
    """sum_i x[..., i] * weights[i] in f32, accumulated from i = 0 up, the
    order of XLA's reduction."""
    out = x[..., 0] * weights[0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i] * weights[i]
    return out


def group_value(a: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """K grouped unit-P inputs (..., K) -> the represented value,
    sum_k A_k (4^g)^(K-1-k), f32 (exact pass-through for K = 1)."""
    g = preprocess_group_size(bits, k)
    return _weighted_sum(a.float(),
                         [float((4 ** g) ** i) for i in range(k - 1, -1, -1)])


def symbol_value(sym: torch.Tensor) -> torch.Tensor:
    """Analog PAM4 symbols (..., M, MSB first) -> value without the
    transceiver decision, sum_m y_m 4^(M-1-m): the float counterpart of
    ``pam4_decode`` for the ONN's analog outputs."""
    m = sym.shape[-1]
    return _weighted_sum(sym.float(),
                         [float(4 ** i) for i in range(m - 1, -1, -1)])


def oracle_from_preprocessed(a: torch.Tensor, bits: int,
                             k: int) -> torch.Tensor:
    """The exact ONN transfer function: preprocessed inputs A (..., K) ->
    PAM4 symbols (..., M) of the quantized average."""
    return pam4_encode(torch.round(group_value(a, bits, k)).to(torch.int32),
                       bits)


def splitter(sym: torch.Tensor, n: int) -> torch.Tensor:
    """Unit T: broadcast the ONN output back to all N servers."""
    return sym[None].expand((n,) + tuple(sym.shape))
