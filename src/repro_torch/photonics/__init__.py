"""The optical subsystem of the port (counterpart of ``repro.photonics``),
split by layer as in the JAX package:

  encoding.py     PAM4 symbols, block quantization, the P unit (eq. 2-3)
  onn.py          the ONN f_theta + ONNConfig + Transceiver (paper IV);
                  every dense layer one launch of the onn_layer kernel;
                  hardware mapping and its numpy oracle
  mzi.py          MZI hardware model: Givens decomposition (numpy)
  approx.py       Sigma_a U_a matrix approximation (paper eq. 4-6)
  mesh.py         the compiled MZI-mesh executor: every mesh stack one
                  launch of the mesh_scan kernel
  area.py         MZI area-cost model (Tables I/II)
  module.py       ONNModule: params and programs per device, the 'onn'
                  and 'mesh' fidelities
  config.py       PhotonicsConfig: the runtime fidelity knob
  pipeline.py     SyncPipeline: Encode -> Preprocess -> MeshApply ->
                  Readout -> Decode, the photonic reduction the optinc
                  backend runs, and the PhaseNoise model of the meshes
  runtime.py      cached ONN resolution for the collective engine
  dataset.py      ONN training data: the full input grid, samples of it
  training.py     hardware-aware ONN training (paper III-B)
  cascade.py      the two-level carry cascade (paper III-C, eq. 8-10)
  error_model.py  Table-II error injection (the Fig. 7a method)
"""
from . import (approx, area, cascade, dataset, encoding, error_model, mesh,
               mzi, onn, pipeline, training)
from .config import FIDELITIES, MESH_BACKENDS, PARAM_SOURCES, PhotonicsConfig
from .mesh import MZIMesh
from .module import ONNModule
from .onn import ONNConfig, Transceiver
from .pipeline import PhaseNoise, SyncPipeline, level_pipeline
from .runtime import get_module, put_module, warmup

__all__ = [
    "PhotonicsConfig", "FIDELITIES", "MESH_BACKENDS", "PARAM_SOURCES",
    "ONNConfig", "ONNModule", "Transceiver", "MZIMesh",
    "PhaseNoise", "SyncPipeline", "level_pipeline",
    "get_module", "put_module", "warmup",
    "approx", "area", "cascade", "dataset", "encoding", "error_model",
    "mesh", "mzi", "onn", "pipeline", "training",
]
