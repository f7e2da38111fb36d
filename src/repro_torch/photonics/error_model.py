"""ONN error-injection model (paper Table II and the Fig. 7a method;
counterpart of ``repro.photonics.error_model``).

An approximated ONN that is not exactly 100% accurate perturbs the
averaged integer gradient with specific error values at specific
relative frequencies.  The paper injects those errors during training to
show that they cost nothing; ``--error-layers`` picks a row of Table II.

``inject`` draws from the port's keys (``prng``): it splits the key in
two, one part for the hit mask and one for the value choice, as JAX
does.  The numbers are not threefry's, so ``inject_with`` holds the
arithmetic on given draws (tests feed it JAX's).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import prng


@dataclasses.dataclass(frozen=True)
class ErrorSpec:
    """P(any error) = 1 - accuracy; given an error, ``values`` are drawn
    with probabilities ``ratios``."""
    accuracy: float
    values: tuple
    ratios: tuple

    @property
    def p_error(self) -> float:
        return 1.0 - self.accuracy


# Paper Table II (scenario 4: B=16, N=4).  Keys = approximated layer sets.
TABLE_II = {
    (4, 5, 6): ErrorSpec(1.0, (), ()),
    (4, 5, 6, 7): ErrorSpec(0.9999986, (1, -1, -64), (0.45, 0.45, 0.10)),
    (4, 5, 6, 7, 8): ErrorSpec(0.9999999, (1024,), (1.0,)),
    (3, 4, 5, 6): ErrorSpec(0.9998891,
                            (1, -1, 1024, -1024, -4),
                            (0.495, 0.495, 0.0045, 0.0045, 0.001)),
    (3, 4, 5, 6, 7): ErrorSpec(0.9999936,
                               (4, -4, -16, 12),
                               (0.3975, 0.3975, 0.17, 0.035)),
}


def draws(key, shape, spec: ErrorSpec, device="cpu"):
    """The hit mask (bool) and value indices (int64) of ``shape`` for
    ``key``: ``split(key)`` gives one key for each, as JAX splits it.  A
    hit is a uniform below p_error; a value index is the first
    cumulative ratio above a uniform."""
    k1, k2 = prng.split(key)
    hit = torch.rand(tuple(shape), generator=prng.generator(k1, device),
                     device=device) < spec.p_error
    cum = torch.tensor(spec.ratios, dtype=torch.float64,
                       device=device).cumsum(0)
    u = torch.rand(tuple(shape), generator=prng.generator(k2, device),
                   dtype=torch.float64, device=device)
    which = torch.searchsorted(cum / cum[-1], u, right=True)
    return hit, which.clamp_max(len(spec.values) - 1)


def inject_with(u_avg: torch.Tensor, hit: torch.Tensor, which: torch.Tensor,
                spec: ErrorSpec, bits: int) -> torch.Tensor:
    """Table-II errors on the averaged offset-binary codes ``u_avg`` for
    given draws (``hit`` and ``which`` broadcast against it): the value
    ``values[which]`` where ``hit``, then the clip to [0, 2^B - 2]."""
    if not spec.values:
        return u_avg
    vals = torch.tensor(spec.values, dtype=torch.int32, device=u_avg.device)
    out = u_avg + torch.where(hit, vals[which.long()], 0)
    return out.clamp(0, 2 ** bits - 2).to(u_avg.dtype)


def inject(key, u_avg: torch.Tensor, spec: ErrorSpec,
           bits: int) -> torch.Tensor:
    """Inject Table-II integer errors into ``u_avg``, drawn from ``key``
    over its whole shape."""
    if not spec.values:
        return u_avg
    hit, which = draws(key, u_avg.shape, spec, u_avg.device)
    return inject_with(u_avg, hit, which, spec, bits)
