"""ONN resolution for the collective engine's photonic fidelities
(counterpart of ``repro.photonics.runtime``).

When ``SyncConfig.photonics.fidelity`` asks for the ``onn`` path, the
optinc backend needs the trained ``ONNModule``.  This module owns that
resolution, keyed by ``(PhotonicsConfig, bits, n_servers)`` and cached
process-wide, so a module is built or loaded once per scenario, not
once per bucket.

For the mesh fidelity the module's meshes are Givens-programmed when
it is resolved, once, as the JAX runtime does: a few seconds of numpy
for the scenario-1 ONN, never inside a training step.

``warmup`` lets the trainer resolve eagerly, so a missing source fails
with guidance before the step loop starts, and places the weights (or,
for the mesh fidelity, the compiled programs) on the run's device.

Trained parameters come from the JAX package's pickles
(``results/scenario1*_params.pkl``, written by ``examples/quickstart.py
--onn --scenario1``), or from training at resolve time
(``params='train'``: ``ONNModule.train`` on the device the caller names,
CUDA by default).  A pickle holds a ``repro.photonics.onn.ONNConfig``;
``_load_results`` maps that class to this package's ``ONNConfig`` while
it unpickles, and imports nothing of ``repro`` or ``jax``.  This package
never writes those pickles: the JAX package would read one back and
unpickle this package's ``ONNConfig``, which imports torch.  Install a
module trained here with ``put_module``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import pickle

from .config import PhotonicsConfig
from .encoding import num_symbols
from .module import ONNModule
from .onn import ONNConfig

_CACHE: dict = {}

# where the JAX package's quickstart --onn --scenario1 persists its
# trained params
RESULTS_PICKLES = ("results/scenario1_cayley_params.pkl",
                   "results/scenario1_params.pkl")

# src/repro_torch/photonics/runtime.py -> the repo root, the JAX
# runtime's anchor (the current directory is tried too)
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# the JAX classes a results pickle names, and what they load as here
_PICKLED_CLASSES = {("repro.photonics.onn", "ONNConfig"): ONNConfig,
                    ("repro.core.onn", "ONNConfig"): ONNConfig}


class _ResultsUnpickler(pickle.Unpickler):
    """Loads a JAX results pickle without importing the JAX package: its
    ONNConfig becomes the port's, and any other class of ``repro`` or
    ``jax`` is refused."""

    def find_class(self, module, name):
        if (module, name) in _PICKLED_CLASSES:
            return _PICKLED_CLASSES[(module, name)]
        if module.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"results pickle names {module}.{name}, which has no "
                f"counterpart in repro_torch")
        return super().find_class(module, name)


def _pickle_candidates():
    for name in RESULTS_PICKLES:
        yield _REPO_ROOT / name
        yield pathlib.Path(name)


def clamp_k(bits: int, k: int) -> int:
    """K cannot exceed the PAM4 symbol count M = ceil(bits/2)."""
    return max(1, min(k, num_symbols(bits)))


def default_structure(bits: int, k_inputs: int) -> tuple:
    """Default ONN structure for a bit width: the paper's scenario-1 shape
    (K, 64, 128, 256, 128, 64, M), collapsing to the exact-identity shape
    when the transfer function is a single symbol."""
    m = num_symbols(bits)
    k = clamp_k(bits, k_inputs)
    if m == 1 and k == 1:
        return (1, 4, 1)
    return (k, 64, 128, 256, 128, 64, m)


def onn_config(ph: PhotonicsConfig, bits: int, n_servers: int) -> ONNConfig:
    k = clamp_k(bits, ph.k_inputs)
    structure = ph.structure or default_structure(bits, ph.k_inputs)
    return ONNConfig(structure=tuple(structure),
                     approx_layers=tuple(ph.approx_layers),
                     bits=bits, n_servers=n_servers, k_inputs=k)


def _load_results(cfg: ONNConfig, adopt_structure: bool) -> ONNModule | None:
    """Load a pickle whose saved ONNConfig is usable for ``cfg``.

    With an explicit requested structure the saved config must match it
    exactly (structure, approx_layers, bits, N, K); with
    ``adopt_structure`` (PhotonicsConfig.structure == (): "use what is
    trained") only (bits, N, K) must match, and the saved structure and
    approx_layers are adopted.  The JAX rules, for the JAX reasons."""
    def fp(c):
        key = (c.bits, c.n_servers, c.k_inputs)
        return key if adopt_structure else (
            key + (tuple(c.structure), tuple(c.approx_layers)))

    for p in _pickle_candidates():
        if not p.exists():
            continue
        with open(p, "rb") as f:
            blob = _ResultsUnpickler(f).load()
        saved = blob.get("cfg")
        if saved is not None and fp(saved) == fp(cfg):
            return ONNModule.from_params(saved if adopt_structure else cfg,
                                         blob["params"])
    return None


def _build(ph: PhotonicsConfig, bits: int, n_servers: int,
           device=None) -> ONNModule:
    cfg = onn_config(ph, bits, n_servers)
    exact_ok = (num_symbols(bits) == 1 and cfg.k_inputs == 1
                and not ph.structure)
    if ph.params == "exact" or (ph.params == "auto" and exact_ok):
        return ONNModule.exact_identity(bits, n_servers)
    if ph.params in ("results", "auto"):
        module = _load_results(cfg, adopt_structure=not ph.structure)
        if module is not None:
            return module
        if ph.params == "results":
            raise ValueError(
                f"photonics params='results' but no matching pickle in "
                f"{RESULTS_PICKLES} for structure {cfg.structure} "
                f"(run `python examples/quickstart.py --onn --scenario1` "
                f"to produce one)")
    if ph.params == "train" or (ph.params == "auto" and ph.train_epochs > 0):
        if ph.train_epochs <= 0:
            raise ValueError("photonics params='train' needs train_epochs>0")
        return ONNModule.train(cfg, epochs=ph.train_epochs, seed=ph.seed,
                               device=device)
    raise ValueError(
        f"cannot resolve an ONN for fidelity={ph.fidelity!r} at bits={bits}: "
        f"no trained params found.  Use --bits 2 (built-in exact identity "
        f"ONN), train scenario-1 params (`python examples/quickstart.py "
        f"--onn --scenario1`), or set PhotonicsConfig(params='train', "
        f"train_epochs=...)")


def _cache_key(ph: PhotonicsConfig, bits: int, n_servers: int):
    # the resolved module does not depend on the mesh executor, its tile
    # or the noise stds (they select how a mesh is applied), so those
    # knobs share one build, as in the JAX runtime
    return (dataclasses.replace(ph, mesh_backend="xla", blk_b=0,
                                theta_drift_std=0.0, shot_noise_std=0.0),
            bits, n_servers)


def get_module(ph: PhotonicsConfig, bits: int, n_servers: int,
               device=None) -> ONNModule:
    """The cached ONNModule for one (photonics, bits, N) scenario; a
    module that has to be trained trains on ``device`` (CUDA when None)."""
    key = _cache_key(ph, bits, n_servers)
    if key not in _CACHE:
        module = _build(ph, bits, n_servers, device)
        if ph.fidelity == "mesh":
            module.programs  # Givens-program the meshes once, eagerly
        _CACHE[key] = module
    return _CACHE[key]


def put_module(ph: PhotonicsConfig, bits: int, n_servers: int,
               module: ONNModule) -> None:
    """Pre-populate the cache (tests, custom-trained modules)."""
    _CACHE[_cache_key(ph, bits, n_servers)] = module


def warmup(sync_cfg, n_servers: int, device=None) -> ONNModule | None:
    """Resolve the ONN for a SyncConfig eagerly (None for behavioral) and,
    given a device, put what its fidelity applies there: the weights, or
    the compiled mesh programs (programmed here if a module installed
    with ``put_module`` has not been yet).  A module with
    ``params='train'`` trains on that device (CUDA when None)."""
    ph = getattr(sync_cfg, "photonics", None)
    if ph is None or ph.fidelity == "behavioral":
        return None
    module = get_module(ph, sync_cfg.bits, n_servers, device)
    if ph.fidelity == "mesh":
        module.programs_on("cpu" if device is None else device)
    elif device is not None:
        module.params_on(device)
    return module
