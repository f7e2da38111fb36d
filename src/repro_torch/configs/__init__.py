"""Architecture registry of the port: ``get(arch)`` / ``get_smoke(arch)``
resolve ``repro_torch.configs.<arch>`` (counterpart of
``repro.configs``).  Only the dense-attention architectures the port
serves so far are registered."""
from __future__ import annotations

import importlib

ARCHS = ["paper_llama", "minitron_4b", "deepseek_coder_33b", "llama3_405b"]


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (ported: {ARCHS})")
    return importlib.import_module(f"{__name__}.{name}")


def get(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
