"""Collective backends of the port: psum | optinc at fidelity
'behavioral' (counterpart of ``repro.collectives.backends``).

Each backend synchronizes ONE fused f32 bucket of the stacked peers,
``x``: (N, elems), and models its own wire bytes (``bytes_on_wire``)
and wire time (``time_on_wire``) exactly as the JAX package does.

OptINC, per bucket: the shared block scale is the max over peers of each
peer's per-block max-abs (JAX: ``compute_scale`` then ``lax.pmax``);
the pam4 encode kernel turns the (N, elems) stack into B-bit
offset-binary codes; the optical fabric's integer sum is an int32 sum
over the peer dimension (JAX: reduce-scatter and all-gather of the
codes); the pam4 decode kernel applies Q(mean) (eq. 3) and dequantizes;
and, with error feedback on, the same decode kernel at n = 1 gives each
peer's input minus its locally quantized gradient, the error-feedback
term.
Integer sums are exact in any order, so the result is bit-identical to
the JAX package's on the same input bucket.

At fidelity 'onn' or 'mesh' the Q(mean) step is the in-network ONN
instead (``_photonic_sync``): after the same shared scale and encode,
the codes run one ``photonics.pipeline`` level (PAM4 symbols, unit P
over the peers, the ONN: dense with every layer one ``onn_layer``
launch, or its MZI meshes with every mesh stack one ``mesh_scan``
launch; the transceiver readout, symbol decode), and ``_finish``
dequantizes the averaged codes with the pam4 decode kernel at n = 1
(Q(mean) of one code is the code), as the behavioral path dequantizes
its code sums.

At fidelity 'mesh' with noise stds set, the pipeline runs the PhaseNoise
model (``photonics.pipeline.PhaseNoise``) from a key folded off the
bucket's sync key (``_noise_key``), so every step and bucket draws its
own noise.

Not ported yet (later slices, ROADMAP.md): the ring and cascade
backends and Table-II error injection (``error_layers``).
"""
from __future__ import annotations

import torch

from .. import prng
from ..kernels.pam4 import pam4_decode_dequantize, pam4_quantize_encode
from ..photonics import pipeline as ph_pipeline
from ..photonics import runtime as ph_runtime
from ..photonics.encoding import QuantSpec, compute_scale
from .bucketizer import DEFAULT_BUCKET_BYTES, expected_buckets
from .registry import register_backend

WIRE_BYTES_PER_S = 100e9     # one 800 Gb/s full-duplex optical transceiver
MESH_RECONFIG_S = 20e-6      # programming one MZI mesh circuit
HOP_LATENCY_S = 1e-6         # one electrical ppermute round (ring baseline)


def _n_buckets(nbytes: float, bucket_bytes: int) -> int:
    return max(expected_buckets(int(max(nbytes, 1) * 2), bucket_bytes), 1)


def _block(cfg, m: int) -> int:
    """The quantization block of an m-element bucket (0 = one block)."""
    return cfg.block if cfg.block > 0 else m


def _shared_scale(x: torch.Tensor, cfg) -> torch.Tensor:
    """Per-block max-abs scale shared by all peers: each peer's
    ``compute_scale``, then the max over the peer dimension (the JAX
    ``lax.pmax``).  x: (N, m) -> (nblocks,)."""
    spec = QuantSpec(bits=cfg.bits, block=cfg.block)
    return torch.stack([compute_scale(row, spec) for row in x]).amax(dim=0)


def _encode(x: torch.Tensor, scale: torch.Tensor, cfg) -> torch.Tensor:
    """(N, m) f32 bucket -> offset-binary B-bit codes (N, nblocks, block),
    zero-block safe: a block whose shared scale is at the f32-tiny floor
    (all zero on every peer) gets the zero code.  The pam4 encode kernel
    on the card, its plain version on the CPU."""
    return pam4_quantize_encode(x, scale, cfg.bits, _block(cfg, x.shape[1]))


def _decode(u: torch.Tensor, scale: torch.Tensor, cfg, n: int, size: int,
            base: torch.Tensor | None = None) -> torch.Tensor:
    """Codes or code sums (rows, nblocks, block) -> f32 (rows, size):
    Q(mean) over n peers, dequantized with the zero-block safe scale
    (n = 1 decodes a peer's own codes); with ``base``, ``base`` minus
    that, rounded once (the error-feedback term, as XLA fuses it)."""
    return pam4_decode_dequantize(u.reshape(u.shape[0], -1), scale,
                                  cfg.bits, n, size, base)


def _finish(total: torch.Tensor, n: int, u: torch.Tensor, x: torch.Tensor,
            scale: torch.Tensor, cfg):
    """Epilogue of both optinc paths (JAX: the tail of ``_quantized_sync``
    and ``_finish_photonic``): Q(mean) over n of the code sums ``total``
    (width,) dequantized, and, with error feedback on, each peer's input
    minus its locally quantized gradient; both through the pam4 decode
    kernel.  The photonic path passes its averaged codes with n = 1."""
    m = x.shape[1]
    out = _decode(total.reshape(1, -1), scale, cfg, n, m)[0]
    if not cfg.error_feedback:
        return out, None
    return out, _decode(u, scale, cfg, 1, m, base=x)


def _noise_key(key, noise):
    """The level key seeding PhaseNoise, folded off the bucket's sync
    key (as JAX folds it, leaving the raw key to Table-II injection).  A
    noisy run without a step key would train noise-free in silence, so
    that combination raises."""
    if noise is None:
        return None
    if key is None:
        raise ValueError(
            "PhotonicsConfig noise (theta_drift_std/shot_noise_std > 0) "
            "needs a per-step sync key; pass key= to sync_flat or "
            "sync_gradients")
    return prng.fold_in(key, 1)


def _photonic_sync(x: torch.Tensor, cfg, key=None):
    """The hardware-in-the-loop OptINC path (fidelity 'onn' or 'mesh'):
    the B-bit codes of the N peers run one ``photonics.pipeline`` level
    instead of the integer Q(mean), with the PhaseNoise model when the
    config sets a noise std."""
    n = x.shape[0]
    ph = cfg.photonics
    module = ph_runtime.get_module(ph, cfg.bits, n, x.device)
    scale = _shared_scale(x, cfg)
    u = _encode(x, scale, cfg)
    noise = ph_pipeline.PhaseNoise.from_config(ph)
    pipe = ph_pipeline.level_pipeline(module, cfg.bits,
                                      fidelity=ph.fidelity,
                                      mesh_backend=ph.mesh_backend,
                                      noise=noise, blk_b=ph.blk_b)
    u_avg = pipe.run(u.reshape(n, -1), key=_noise_key(key, noise)).data
    return _finish(u_avg, 1, u, x, scale, cfg)


class PsumBackend:
    """Exact all-reduce mean over the peers (reference)."""
    name = "psum"

    def sync(self, x, cfg, key=None):
        return x.sum(dim=0) / x.shape[0], None

    def bytes_on_wire(self, nbytes: float, n: int, bits: int) -> float:
        # ring-equivalent all-reduce: RS + AG, (N-1)/N of the payload each
        return 2.0 * (n - 1) / max(n, 1) * nbytes

    def time_on_wire(self, nbytes: float, n: int, bits: int,
                     overlap: bool = False,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> float:
        # electrical all-reduce: nothing to reconfigure, the wire stays
        # saturated either way; 2(N-1) serial rounds pay a hop each
        return (self.bytes_on_wire(nbytes, n, bits) / WIRE_BYTES_PER_S
                + 2.0 * (n - 1) * HOP_LATENCY_S)


class OptincBackend:
    """Quantize -> in-network sum -> Q(mean) -> dequantize; at fidelity
    'behavioral' Q(mean) in the integer domain, at 'onn' or 'mesh'
    through the ONN (the module docstring has the steps)."""
    name = "optinc"

    def sync(self, x, cfg, key=None):
        """One bucket (N, elems); ``key`` is the bucket's sync key, which
        only the PhaseNoise model draws from."""
        if cfg.photonics.fidelity != "behavioral":
            return _photonic_sync(x, cfg, key)
        scale = _shared_scale(x, cfg)
        u = _encode(x, scale, cfg)
        total = u.sum(dim=0, dtype=torch.int32)
        return _finish(total, x.shape[0], u, x, scale, cfg)

    def bytes_on_wire(self, nbytes: float, n: int, bits: int) -> float:
        # one send of the B-bit codes into the optical fabric per server
        return (nbytes / 2.0) * bits / 8.0

    def time_on_wire(self, nbytes: float, n: int, bits: int,
                     overlap: bool = False,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> float:
        # one reduction circuit per bucket: program the mesh, stream the
        # codes through at line rate; streaming hides every
        # reconfiguration after the first behind the previous transfer
        t = self.bytes_on_wire(nbytes, n, bits) / WIRE_BYTES_PER_S
        nb = _n_buckets(nbytes, bucket_bytes)
        if not overlap:
            return nb * MESH_RECONFIG_S + t
        t_bucket = t / nb
        return (MESH_RECONFIG_S + t
                + max(0.0, MESH_RECONFIG_S - t_bucket) * (nb - 1))


register_backend("psum", PsumBackend())
register_backend("optinc", OptincBackend())
