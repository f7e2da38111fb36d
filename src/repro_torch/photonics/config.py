"""PhotonicsConfig: the runtime fidelity knob of the optical subsystem
(counterpart of ``repro.photonics.config``).

One frozen dataclass describes how faithfully the collective engine
emulates the in-network ONN:

  fidelity='behavioral'  Q(mean) computed directly in the integer domain
                         (paper eq. 3): bit-exact by definition.
  fidelity='onn'         the PAM4 symbol stream runs through the trained
                         dense ONN (``onn.apply``, every layer one launch
                         of the ``onn_layer`` kernel) and the transceiver
                         readout.
  fidelity='mesh'        the phase-programmed MZI mesh emulator itself
                         (``mesh.py``: every rotation mesh one launch of
                         the ``mesh_scan`` kernel) computes the ONN's
                         analog outputs.

``SyncConfig.photonics`` carries this config into the optinc backend;
the training CLI sets its fidelity from ``--fidelity``.  The fields and
their validation are the JAX package's, so a config round-trips between
the two; ``resolve_interpret`` (Pallas only) has no counterpart.
"""
from __future__ import annotations

import dataclasses

FIDELITIES = ("behavioral", "onn", "mesh")

PARAM_SOURCES = ("auto", "exact", "results", "train")

# how fidelity='mesh' executes the compiled rotation-layer stacks.  In
# the JAX package 'xla' is a lax.scan of one gather+FMA per layer and
# 'pallas' the fused Pallas kernel.  The port has one executor: both
# values run the mesh_scan kernel (kernels/mesh_scan.py) for CUDA tensors
# and its plain version for CPU tensors, and never the plain version on
# the card.  The field stays so that configs round-trip with JAX, and
# blk_b is that kernel's row tile: the rows one CUDA block holds in its
# warps' registers (a multiple of 8, at most 8 warps of 16 rows up to
# 256 wires; 0 = its default of 4 warps).
MESH_BACKENDS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class PhotonicsConfig:
    """Optical-subsystem runtime knobs.

    ``structure``/``approx_layers`` describe the in-network ONN of the
    ``onn``/``mesh`` fidelities; ``()`` derives a default from the sync
    bit width (``runtime.default_structure``).  ``params`` selects where
    the trained weights come from:

      'exact'    analytically exact identity ONN, only possible when the
                 transfer function is linear: one PAM4 symbol per value
                 and one ONN input (bits <= 2, k_inputs == 1)
      'results'  results/scenario1*_params.pkl (written by the JAX
                 package's ``examples/quickstart.py --onn --scenario1``)
      'train'    hardware-aware training at resolve time
      'auto'     exact if possible, else results, else an error with
                 guidance

    ``mesh_backend`` and ``blk_b`` belong to the mesh fidelity (see
    ``MESH_BACKENDS``); ``theta_drift_std`` and ``shot_noise_std`` to its
    PhaseNoise model (``pipeline.PhaseNoise``).
    """
    fidelity: str = "behavioral"
    structure: tuple = ()          # () = auto from bits/k_inputs
    approx_layers: tuple = ()
    k_inputs: int = 4              # K (clamped to the symbol count M)
    params: str = "auto"           # auto | exact | results | train
    train_epochs: int = 0          # 'train' source budget (0 = refuse)
    seed: int = 0
    mesh_backend: str = "xla"      # fidelity='mesh' executor: xla | pallas
    blk_b: int = 0                 # mesh kernel row tile (0 = default)
    theta_drift_std: float = 0.0   # thermal drift on programmed phases (rad)
    shot_noise_std: float = 0.0    # additive noise on analog outputs

    def __post_init__(self):
        if self.fidelity not in FIDELITIES:
            raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                             f"got {self.fidelity!r}")
        if self.params not in PARAM_SOURCES:
            raise ValueError(f"params must be one of {PARAM_SOURCES}, "
                             f"got {self.params!r}")
        if self.mesh_backend not in MESH_BACKENDS:
            raise ValueError(f"mesh_backend must be one of {MESH_BACKENDS}, "
                             f"got {self.mesh_backend!r}")
        if self.blk_b < 0 or self.blk_b % 8:
            raise ValueError(
                f"blk_b must be a multiple of the 8-row sublane tile "
                f"(0 = auto), got {self.blk_b!r}")
        if self.theta_drift_std < 0.0 or self.shot_noise_std < 0.0:
            raise ValueError(
                f"noise stds must be >= 0, got theta_drift_std="
                f"{self.theta_drift_std!r} shot_noise_std="
                f"{self.shot_noise_std!r}")
