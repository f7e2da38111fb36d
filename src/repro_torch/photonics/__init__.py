"""The optical subsystem of the port (counterpart of ``repro.photonics``),
split by layer as in the JAX package:

  encoding.py     PAM4 symbols, block quantization, the P unit (eq. 2-3)
  onn.py          the ONN f_theta + ONNConfig + Transceiver (paper IV);
                  every dense layer one launch of the onn_layer kernel
  area.py         MZI area-cost model (Tables I/II)
  module.py       ONNModule: params per device, the 'onn' fidelity
  config.py       PhotonicsConfig: the runtime fidelity knob
  pipeline.py     SyncPipeline: Encode -> Preprocess -> MeshApply ->
                  Readout -> Decode, the photonic reduction the optinc
                  backend runs
  runtime.py      cached ONN resolution for the collective engine

Not ported yet (ROADMAP.md): the mesh fidelity (``mzi``, ``approx``,
``mesh``, ``PhaseNoise`` and the mesh_scan kernel), ONN training
(``training``, ``dataset``), ``error_model`` and ``cascade``.
"""
from . import area, encoding, onn, pipeline
from .config import FIDELITIES, MESH_BACKENDS, PARAM_SOURCES, PhotonicsConfig
from .module import ONNModule
from .onn import ONNConfig, Transceiver
from .pipeline import SyncPipeline, level_pipeline
from .runtime import get_module, put_module, warmup

__all__ = [
    "PhotonicsConfig", "FIDELITIES", "MESH_BACKENDS", "PARAM_SOURCES",
    "ONNConfig", "ONNModule", "Transceiver",
    "SyncPipeline", "level_pipeline",
    "get_module", "put_module", "warmup",
    "area", "encoding", "onn", "pipeline",
]
