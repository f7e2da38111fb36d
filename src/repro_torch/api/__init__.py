"""repro_torch.api — the declarative entry-point layer of the port
(counterpart of ``repro.api``).

  RunSpec / MeshSpec / CheckpointConfig  (spec.py)     : describe a run
  TrainSession                           (session.py)  : run it
  ServeSession                           (serve.py)    : serve it
  callbacks                              (callbacks.py): log / checkpoint
  build_* helpers                        (build.py)    : its steps

``launch/train.py`` is a thin client of this package.  The names of
JAX's ``api`` that have no twin yet raise when they are looked up:
``ElasticTrainSession`` and ``Membership`` (elastic membership), and the
PartitionSpec helpers ``param_specs``, ``sync_state_specs`` and
``decode_cache_specs`` (shard_map shardings; the message names the
local-shard functions that do their work here).
"""
from ..collectives import SyncConfig
from ..data.pipeline import DataConfig
from ..elastic import ElasticConfig, ElasticError
from ..optim import AdamWConfig
from ..photonics.config import PhotonicsConfig
from ..serving.config import ServeConfig
from .build import (build_decode_step, build_prefill_step, build_train_step,
                    init_sync_state, modeled_bytes_on_wire,
                    modeled_time_on_wire)
from .callbacks import (Callback, JsonlLogger, PeriodicCheckpoint,
                        RankReport, SigtermHandler, StragglerWatchdog,
                        default_callbacks)
from .serve import ServeSession
from .session import TrainSession
from .spec import (CheckpointConfig, MeshSpec, ResumeCompat, RunSpec,
                   SpecError, SpecMismatchError, check_resume_compat,
                   validate_resume_compat)

__all__ = [
    "RunSpec", "MeshSpec", "CheckpointConfig", "ServeConfig", "SyncConfig",
    "AdamWConfig", "DataConfig", "PhotonicsConfig", "ElasticConfig",
    "SpecError", "SpecMismatchError",
    "ResumeCompat", "check_resume_compat", "validate_resume_compat",
    "ElasticError", "TrainSession", "ServeSession",
    "Callback", "JsonlLogger", "PeriodicCheckpoint", "RankReport",
    "SigtermHandler", "StragglerWatchdog", "default_callbacks",
    "build_train_step", "build_prefill_step", "build_decode_step",
    "init_sync_state", "modeled_bytes_on_wire", "modeled_time_on_wire",
]

_NO_TWIN = {
    "ElasticTrainSession": "elastic membership is not ported yet",
    "Membership": "elastic membership is not ported yet",
    "param_specs": "param_specs is a shard_map sharding, which has no "
                   "twin in the port: a rank's shards are "
                   "repro_torch.models.lm.local_param_shapes and "
                   "lm.shard_params (the specs: lm.param_specs)",
    "sync_state_specs": "sync_state_specs is a shard_map sharding, which "
                        "has no twin in the port: a rank's residual sizes "
                        "are repro_torch.launch.steps._local_leaf_sizes "
                        "(steps.init_sync_state)",
    "decode_cache_specs": "decode_cache_specs is a shard_map sharding, "
                          "which has no twin in the port: serving runs "
                          "unsharded on one process (the paged pool of "
                          "api.build.new_decode_cache); a rank's weight "
                          "shards are repro_torch.models.lm."
                          "local_param_shapes",
}


def __getattr__(name):
    if name in _NO_TWIN:
        raise NotImplementedError(f"repro_torch.api.{name}: "
                                  f"{_NO_TWIN[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
