"""Stage-composable photonic sync pipeline (counterpart of
``repro.photonics.pipeline``, paper III-A / III-C).

One level of the OptINC fabric is five small stages over the codes of
the N data-parallel peers, stacked on one card as a leading peer
dimension:

    Encode      offset-binary codes -> PAM4 symbols -> grouped unit-P
                input values (eq. 2); an incoming eq.-10 carry rides on
                the least-significant group
    Preprocess  unit P: the exact sum over the peer dimension / N (the
                single-card form of the JAX ``lax.psum`` over 'data');
                for peers as processes this rank's values summed over
                the level's axes (``ProcessAxes.psum``), JAX's form
    MeshApply   the in-network ONN: the trained dense forward ('onn'),
                one ``onn_layer`` launch per layer, or the phase-
                programmed MZI mesh emulator ('mesh'), one ``mesh_scan``
                launch per mesh stack, with the PhaseNoise model on the
                programmed thetas and the analog outputs
    Readout     transceiver decision stage; with ``emit_carry`` the
                eq.-10 decimal part d = analog value - decoded value
                leaves the level as ``Carry.frac``
    Decode      PAM4 symbols -> offset-binary integer codes

Each stage is a frozen dataclass with ``apply(carry, key) -> carry``; a
``SyncPipeline`` folds a per-stage key off the level key
(``prng.fold_in``) and runs the stages in order.  The optinc backend
runs ONE pipeline per bucket; the cascade runs two: level 0 with
``emit_carry`` over the (dp, pods * L) codes, each pod's dp peers
reduced at once with the pods side by side along the code axis, then
level 1 over the (pods, L) level-0 codes with their carry.

Preprocess divides by N as the compiled JAX step does, by multiplying
with the f32 reciprocal of N (XLA's rewrite of a division by a
constant), so the values the ONN sees are bit-identical to JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import prng
from .encoding import (f32_reciprocal, group_symbols, pam4_decode,
                       pam4_encode, symbol_value)


class Carry(NamedTuple):
    """What flows between stages: the payload and the eq.-10 carry."""
    data: torch.Tensor                # stage payload (codes/values/symbols)
    frac: torch.Tensor | None = None  # decimal carry d, in value units


# --------------------------------------------------------------- noise

@dataclasses.dataclass(frozen=True)
class PhaseNoise:
    """Thermal drift + shot noise on the emulated MZI mesh.

    ``theta_drift_std`` perturbs every programmed phase theta -> theta +
    eps with one eps ~ N(0, std) PER ROTATION and apply (an MZI has one
    thermal phase shifter, so its two wires rotate coherently);
    ``shot_noise_std`` adds white photodetector noise to the analog
    outputs after the optical path.  Both draw from the key threaded
    through ``MZIMesh.apply`` (derived from the per-step sync key), so
    the noise is reproducible.  A zero std turns its term off: the
    noise-free arithmetic runs unchanged, bit for bit.
    """
    theta_drift_std: float = 0.0
    shot_noise_std: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.theta_drift_std > 0.0 or self.shot_noise_std > 0.0

    @classmethod
    def from_config(cls, ph) -> "PhaseNoise | None":
        """PhotonicsConfig -> PhaseNoise, or None when both stds are 0."""
        noise = cls(theta_drift_std=ph.theta_drift_std,
                    shot_noise_std=ph.shot_noise_std)
        return noise if noise.enabled else None

    def perturb(self, key, perm: torch.Tensor, ca: torch.Tensor,
                sa: torch.Tensor):
        """Drift the (..., L, m) coefficient stacks of a compiled mesh
        with one gaussian per wire drawn from ``key`` on their device
        (``perturb_with`` has the arithmetic)."""
        if self.theta_drift_std <= 0.0 or key is None:
            return ca, sa
        return self.perturb_with(
            prng.normal(key, perm.shape, ca.dtype, ca.device), perm, ca, sa)

    def perturb_with(self, g: torch.Tensor, perm: torch.Tensor,
                     ca: torch.Tensor, sa: torch.Tensor):
        """The drift of ``perturb`` for given gaussians ``g`` (perm's
        shape).  A rotation on wires (i, j) stores ca = cos(theta) on
        both wires and sa = -+ sin(theta); symmetrizing the per-wire
        gaussians over the partner permutation gives one delta per
        rotation, and the antisymmetric sign(wire - partner) turns the
        per-wire update
            ca' = ca cos(eps) - sa sin(eps)
            sa' = sa cos(eps) + ca sin(eps)
        into a coherent theta -> theta + delta on both wires.  Untouched
        wires (perm == self) get eps = 0 exactly, so identity padding
        stays identity."""
        perm = perm.long()
        # (g_i + g_j)/sqrt(2) of two iid N(0,1) draws is N(0,1) again, so
        # the per-rotation drift really has std = theta_drift_std
        delta = (0.5 ** 0.5) * (g + torch.gather(g, -1, perm))
        wires = torch.arange(perm.shape[-1], device=perm.device)
        sign = torch.sign(wires - perm).to(ca.dtype)
        eps = self.theta_drift_std * delta * sign
        ce, se = torch.cos(eps), torch.sin(eps)
        return ca * ce - sa * se, sa * ce + ca * se

    def shot(self, key, y: torch.Tensor) -> torch.Tensor:
        """Additive photodetector noise on the analog mesh outputs."""
        if self.shot_noise_std <= 0.0 or key is None:
            return y
        return y + self.shot_noise_std * prng.normal(key, y.shape, y.dtype,
                                                     y.device)


# --------------------------------------------------------------- stages

@dataclasses.dataclass(frozen=True)
class Encode:
    """Offset-binary integer codes (N, L) -> grouped unit-P input values
    (N, L, K) f32.  An incoming eq.-10 carry (``carry.frac``, value
    units) is added to the least-significant group."""
    bits: int
    k_inputs: int

    def apply(self, carry: Carry, key=None) -> Carry:
        sym = pam4_encode(carry.data, self.bits)
        vals = group_symbols(sym, self.bits, self.k_inputs).float()
        if carry.frac is not None:
            vals[..., -1] += carry.frac
        return Carry(vals)


@dataclasses.dataclass(frozen=True)
class Preprocess:
    """Unit P over the stacked peers: (N, L, K) -> (L, K), the sum over
    the peer dimension times f32(1/N).  The grouped values are small
    integers, so the f32 sum is exact in any order.  With ``world``
    (peers as processes) the rank's (1, L, K) values are summed over
    ``axes`` and N is their size."""
    world: object = None            # launch.distributed.ProcessAxes
    axes: tuple = ()

    def apply(self, carry: Carry, key=None) -> Carry:
        total, n = carry.data.sum(dim=0), carry.data.shape[0]
        if self.world is not None:
            total = self.world.psum(total, self.axes)
            n = self.world.axis_size(self.axes)
        return Carry(total * f32_reciprocal(n))


@dataclasses.dataclass(frozen=True)
class MeshApply:
    """The in-network ONN: the dense forward pass ('onn') or the MZI mesh
    emulator ('mesh'; both ``mesh_backend`` values run the ``mesh_scan``
    kernel, with ``blk_b`` its row tile), with the PhaseNoise model
    injected into ``MZIMesh.apply``."""
    module: object                  # ONNModule
    fidelity: str = "onn"
    mesh_backend: str | None = None
    noise: PhaseNoise | None = None
    blk_b: int = 0                  # mesh kernel row tile (0 = default)

    def apply(self, carry: Carry, key=None) -> Carry:
        if self.fidelity == "mesh":
            return Carry(self.module.apply_mesh(
                carry.data, backend=self.mesh_backend, noise=self.noise,
                key=key, blk_b=self.blk_b))
        return Carry(self.module.apply(carry.data))


@dataclasses.dataclass(frozen=True)
class Readout:
    """Transceiver decision stage (paper's ADC): analog symbols -> PAM4.

    With ``emit_carry`` the eq.-10 decimal part leaves as ``frac``: the
    ANALOG value the ONN computed minus the decoded integer decision."""
    transceiver: object             # onn.Transceiver
    emit_carry: bool = False

    def apply(self, carry: Carry, key=None) -> Carry:
        sym = self.transceiver.readout(carry.data)
        frac = None
        if self.emit_carry:
            frac = symbol_value(carry.data) - pam4_decode(sym).float()
        return Carry(sym, frac)


@dataclasses.dataclass(frozen=True)
class Decode:
    """PAM4 symbols -> offset-binary integer codes; an outgoing carry
    stays attached."""

    def apply(self, carry: Carry, key=None) -> Carry:
        return Carry(pam4_decode(carry.data), carry.frac)


@dataclasses.dataclass(frozen=True)
class SyncPipeline:
    """An ordered stage tuple for ONE reduction level of the fabric."""
    stages: tuple

    def run(self, data: torch.Tensor, key=None,
            frac: torch.Tensor | None = None) -> Carry:
        """Thread ``Carry(data, frac)`` through the stages.  Each stage
        receives its own key (folded off ``key`` by stage index), so
        stage-level randomness (PhaseNoise) is reproducible per level."""
        carry = Carry(data, frac)
        for i, stage in enumerate(self.stages):
            carry = stage.apply(carry,
                                None if key is None else prng.fold_in(key, i))
        return carry


def level_pipeline(module, bits: int, fidelity: str = "onn",
                   mesh_backend: str | None = None,
                   noise: PhaseNoise | None = None,
                   emit_carry: bool = False, blk_b: int = 0,
                   world=None, axes: tuple = ()) -> SyncPipeline:
    """The Encode -> Preprocess -> MeshApply -> Readout -> Decode pipeline
    of one reduction level over the stacked peers, or over the ``axes``
    of peers as processes (``world``)."""
    return SyncPipeline(stages=(
        Encode(bits=bits, k_inputs=module.cfg.k_inputs),
        Preprocess(world=world, axes=tuple(axes)),
        MeshApply(module=module, fidelity=fidelity,
                  mesh_backend=mesh_backend, noise=noise, blk_b=blk_b),
        Readout(transceiver=module.transceiver, emit_carry=emit_carry),
        Decode(),
    ))
