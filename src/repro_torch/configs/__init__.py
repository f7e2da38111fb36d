"""Architecture registry of the port: ``get(arch)`` / ``get_smoke(arch)``
resolve ``repro_torch.configs.<arch>`` (counterpart of
``repro.configs``).  Registered: the dense-attention architectures and
the MoE family (phi35_moe_42b: GQA with routed experts; deepseek_v3_671b:
MLA, shared and routed experts, MTP) and the encoder-decoder family
(whisper_tiny, trained through ``launch.steps.make_train_step`` on
batches that carry ``enc_frames``), which the port trains; it serves
the dense ones only.  The SSM and xLSTM families are not ported."""
from __future__ import annotations

import importlib

ARCHS = ["paper_llama", "minitron_4b", "deepseek_coder_33b", "llama3_405b",
         "phi35_moe_42b", "deepseek_v3_671b", "whisper_tiny"]


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (ported: {ARCHS})")
    return importlib.import_module(f"{__name__}.{name}")


def get(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
