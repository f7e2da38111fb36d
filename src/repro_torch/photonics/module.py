"""ONNModule: one in-network ONN as a device-ready object (counterpart of
``repro.photonics.module``).

Bundles the ``ONNConfig``, the trained dense parameters and their
phase-programmed mesh emulation behind the fidelity levels the
collective engine exposes:

    module.apply(a)        dense forward pass, one ``onn_layer`` launch
                           per layer (fidelity='onn')
    module.apply_mesh(a)   the compiled MZI meshes, one ``mesh_scan``
                           launch per mesh stack (fidelity='mesh')
    module.symbols(a, ...) either of the above + transceiver readout

The parameters and the compiled programs are kept on the CPU, as the JAX
module keeps numpy; the first use on a device copies them there once
(``params_on``, ``programs_on``).  ``programs`` Givens-programs the
meshes at its first call and caches them (``runtime`` calls it when it
resolves a module for the mesh fidelity).  ``train`` runs the
hardware-aware training of ``training.py`` on a device (CUDA unless the
caller says otherwise) and keeps the result on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import mesh as mesh_mod
from . import onn as onn_mod
from .encoding import num_symbols
from .onn import ONNConfig, Transceiver


def _cpu_f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


@dataclasses.dataclass
class ONNModule:
    cfg: ONNConfig
    params: list                       # dense layer dicts ({"w", "b"}), CPU
    transceiver: Transceiver = dataclasses.field(default_factory=Transceiver)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)
    _programs: list | None = dataclasses.field(default=None, repr=False)
    _programs_on: dict = dataclasses.field(default_factory=dict,
                                           repr=False)

    # ------------------------------------------------------ constructors
    @classmethod
    def init(cls, cfg: ONNConfig, seed: int = 0) -> "ONNModule":
        return cls(cfg, onn_mod.init_params(cfg, seed, "cpu"))

    @classmethod
    def from_params(cls, cfg: ONNConfig, params) -> "ONNModule":
        """params: a list of {"w", "b"}, tensors or arrays (numpy, or
        anything ``np.array`` takes)."""
        return cls(cfg, [{k: _cpu_f32(l[k]) for k in ("w", "b")}
                         for l in params])

    @classmethod
    def exact_identity(cls, bits: int, n_servers: int) -> "ONNModule":
        """Analytically exact ONN for the single-symbol transfer function.

        With M = num_symbols(bits) == 1 and K = 1 the behavioural target
        Q(mean) is just round(A), so a (1, 4, 1) identity network plus the
        transceiver's rounding IS the oracle.  The weights are the
        wire-exact form of the JAX module (w1 = e1, w2 = e1^T): the value
        rides a single waveguide, and the only float operations left are
        the in/out scale pair a * f32(1/3) * 3, exact at every
        half-integer of [0, 2^B - 2], so PAM4 decision ties resolve like
        ``torch.round``'s round-half-even, bit-identical to the
        behavioral backend."""
        if num_symbols(bits) != 1:
            raise ValueError(
                f"exact identity ONN needs a single PAM4 symbol per value "
                f"(bits <= 2), got bits={bits}")
        cfg = ONNConfig(structure=(1, 4, 1), approx_layers=(), bits=bits,
                        n_servers=n_servers, k_inputs=1)
        w1 = np.zeros((4, 1), np.float32)
        w1[0, 0] = 1.0
        params = [{"w": w1, "b": np.zeros((4,), np.float32)},
                  {"w": w1.T.copy(), "b": np.zeros((1,), np.float32)}]
        return cls.from_params(cfg, params)

    @classmethod
    def train(cls, cfg: ONNConfig, epochs: int, seed: int = 0,
              samples: int = 0, device=None, **train_kw) -> "ONNModule":
        """Hardware-aware training (cayley mode: constraint-exact) on
        ``device`` (CUDA by default), over the full input grid or
        ``samples`` samples of it."""
        from . import dataset, training
        if samples:
            a, t = dataset.sampled_dataset(
                cfg, np.random.default_rng(seed), samples)
        else:
            a, t = dataset.full_dataset(cfg)
        tcfg = training.TrainConfig(
            epochs=epochs, e1=int(epochs * 0.8), mode="cayley", seed=seed,
            **train_kw)
        params, _ = training.train(cfg, tcfg, a, t, eval_every=0,
                                   device=device)
        return cls.from_params(cfg, params)

    # ------------------------------------------------------ fidelities
    def params_on(self, device) -> list:
        """The parameters on ``device``, copied there once."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.params
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = [{k: v.to(device) for k, v in l.items()}
                                    for l in self.params]
        return self._on_device[key]

    def apply(self, a: torch.Tensor) -> torch.Tensor:
        """Dense forward pass -> analog outputs in symbol units, on a's
        device."""
        return onn_mod.apply(self.params_on(a.device), a, self.cfg)

    @property
    def programs(self) -> list:
        """Compiled MZI-mesh layer programs (Givens-programmed once), CPU
        f32 tensors."""
        if self._programs is None:
            hw = onn_mod.map_to_hardware(self.params, self.cfg)
            self._programs = mesh_mod.compile_hardware(hw)
        return self._programs

    def programs_on(self, device) -> list:
        """The compiled programs on ``device``, copied there once."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.programs
        key = str(device)
        if key not in self._programs_on:
            self._programs_on[key] = [p.to(device) for p in self.programs]
        return self._programs_on[key]

    def apply_mesh(self, a: torch.Tensor, backend: str | None = None,
                   noise=None, key=None, blk_b: int = 0) -> torch.Tensor:
        """Forward pass through the phase-programmed mesh emulator on a's
        device.  ``backend`` is ``PhotonicsConfig.mesh_backend`` (both
        values run the ``mesh_scan`` kernel) and ``blk_b`` its row tile;
        ``noise`` + ``key`` inject the PhaseNoise model (pipeline.py)."""
        return mesh_mod.apply_hardware(self.programs_on(a.device), a,
                                       self.cfg, backend=backend,
                                       noise=noise, key=key, blk_b=blk_b)

    def symbols(self, a: torch.Tensor, fidelity: str = "onn",
                mesh_backend: str | None = None, noise=None, key=None,
                blk_b: int = 0) -> torch.Tensor:
        """Analog forward pass + transceiver readout -> PAM4 symbols."""
        out = (self.apply_mesh(a, backend=mesh_backend, noise=noise,
                               key=key, blk_b=blk_b)
               if fidelity == "mesh" else self.apply(a))
        return self.transceiver.readout(out)

    # ------------------------------------------------------ diagnostics
    def accuracy(self, a, tgt, device=None) -> float:
        """``training.accuracy`` of the parameters on ``device`` (CUDA by
        default): the dense forward pass, not a kernel."""
        from . import training
        return training.accuracy(self.params, a, tgt, self.cfg,
                                 device=device)

    def area_ratio(self) -> float:
        return onn_mod.area_ratio(self.cfg)
