"""Stage-composable photonic sync pipeline (counterpart of
``repro.photonics.pipeline``, paper III-A / III-C).

One level of the OptINC fabric is five small stages over the codes of
the N data-parallel peers, stacked on one card as a leading peer
dimension:

    Encode      offset-binary codes -> PAM4 symbols -> grouped unit-P
                input values (eq. 2); an incoming eq.-10 carry rides on
                the least-significant group
    Preprocess  unit P: the exact sum over the peer dimension / N (the
                single-card form of the JAX ``lax.psum`` over 'data')
    MeshApply   the in-network ONN: the trained dense forward ('onn'),
                one ``onn_layer`` launch per layer, or the phase-
                programmed MZI mesh emulator ('mesh'), one ``mesh_scan``
                launch per mesh stack
    Readout     transceiver decision stage; with ``emit_carry`` the
                eq.-10 decimal part d = analog value - decoded value
                leaves the level as ``Carry.frac``
    Decode      PAM4 symbols -> offset-binary integer codes

Each stage is a frozen dataclass with ``apply(carry) -> carry``; a
``SyncPipeline`` runs them in order.  The optinc backend runs ONE
pipeline per bucket.  The JAX stages also take a key for the mesh
fidelity's PhaseNoise model; PhaseNoise is not ported yet (its slice
threads a per-step key through the stages), so the port's stages take
none and the mesh emulator runs noise-free.

Preprocess divides by N as the compiled JAX step does, by multiplying
with the f32 reciprocal of N (XLA's rewrite of a division by a
constant), so the values the ONN sees are bit-identical to JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .encoding import (f32_reciprocal, group_symbols, pam4_decode,
                       pam4_encode, symbol_value)


class Carry(NamedTuple):
    """What flows between stages: the payload and the eq.-10 carry."""
    data: torch.Tensor                # stage payload (codes/values/symbols)
    frac: torch.Tensor | None = None  # decimal carry d, in value units


@dataclasses.dataclass(frozen=True)
class Encode:
    """Offset-binary integer codes (N, L) -> grouped unit-P input values
    (N, L, K) f32.  An incoming eq.-10 carry (``carry.frac``, value
    units) is added to the least-significant group."""
    bits: int
    k_inputs: int

    def apply(self, carry: Carry) -> Carry:
        sym = pam4_encode(carry.data, self.bits)
        vals = group_symbols(sym, self.bits, self.k_inputs).float()
        if carry.frac is not None:
            vals[..., -1] += carry.frac
        return Carry(vals)


@dataclasses.dataclass(frozen=True)
class Preprocess:
    """Unit P over the stacked peers: (N, L, K) -> (L, K), the sum over
    the peer dimension times f32(1/N).  The grouped values are small
    integers, so the f32 sum is exact in any order."""

    def apply(self, carry: Carry) -> Carry:
        n = carry.data.shape[0]
        return Carry(carry.data.sum(dim=0) * f32_reciprocal(n))


@dataclasses.dataclass(frozen=True)
class MeshApply:
    """The in-network ONN: the dense forward pass ('onn') or the MZI mesh
    emulator ('mesh'; ``mesh_backend`` is validated and both values run
    the ``mesh_scan`` kernel, with ``blk_b`` its row tile)."""
    module: object                  # ONNModule
    fidelity: str = "onn"
    mesh_backend: str | None = None
    blk_b: int = 0                  # mesh kernel row tile (0 = default)

    def apply(self, carry: Carry) -> Carry:
        if self.fidelity == "mesh":
            return Carry(self.module.apply_mesh(
                carry.data, backend=self.mesh_backend, blk_b=self.blk_b))
        return Carry(self.module.apply(carry.data))


@dataclasses.dataclass(frozen=True)
class Readout:
    """Transceiver decision stage (paper's ADC): analog symbols -> PAM4.

    With ``emit_carry`` the eq.-10 decimal part leaves as ``frac``: the
    ANALOG value the ONN computed minus the decoded integer decision."""
    transceiver: object             # onn.Transceiver
    emit_carry: bool = False

    def apply(self, carry: Carry) -> Carry:
        sym = self.transceiver.readout(carry.data)
        frac = None
        if self.emit_carry:
            frac = symbol_value(carry.data) - pam4_decode(sym).float()
        return Carry(sym, frac)


@dataclasses.dataclass(frozen=True)
class Decode:
    """PAM4 symbols -> offset-binary integer codes; an outgoing carry
    stays attached."""

    def apply(self, carry: Carry) -> Carry:
        return Carry(pam4_decode(carry.data), carry.frac)


@dataclasses.dataclass(frozen=True)
class SyncPipeline:
    """An ordered stage tuple for ONE reduction level of the fabric."""
    stages: tuple

    def run(self, data: torch.Tensor,
            frac: torch.Tensor | None = None) -> Carry:
        carry = Carry(data, frac)
        for stage in self.stages:
            carry = stage.apply(carry)
        return carry


def level_pipeline(module, bits: int, fidelity: str = "onn",
                   mesh_backend: str | None = None,
                   emit_carry: bool = False, blk_b: int = 0) -> SyncPipeline:
    """The Encode -> Preprocess -> MeshApply -> Readout -> Decode pipeline
    of one reduction level over the stacked peers."""
    return SyncPipeline(stages=(
        Encode(bits=bits, k_inputs=module.cfg.k_inputs),
        Preprocess(),
        MeshApply(module=module, fidelity=fidelity,
                  mesh_backend=mesh_backend, blk_b=blk_b),
        Readout(transceiver=module.transceiver, emit_carry=emit_carry),
        Decode(),
    ))
