"""Architecture registry of the port: ``get(arch)`` / ``get_smoke(arch)``
resolve ``repro_torch.configs.<arch>`` (counterpart of
``repro.configs``).  Registered: the dense-attention architectures
(with qk-norm: qwen3_32b, chameleon_34b), the MoE family
(phi35_moe_42b: GQA with routed experts; deepseek_v3_671b: MLA, shared
and routed experts, MTP), the encoder-decoder family (whisper_tiny,
trained through ``launch.steps.make_train_step`` on batches that carry
``enc_frames``), the Mamba-2 hybrid (zamba2_7b: mamba2 layers with
one shared attention block) and the xLSTM family (xlstm_125m: mLSTM
layers with an sLSTM layer every ``slstm_every``), which the port
trains.  It serves the dense ones on the paged path and xLSTM through
``ServeSession``'s recurrent state."""
from __future__ import annotations

import importlib

ARCHS = ["paper_llama", "minitron_4b", "deepseek_coder_33b", "llama3_405b",
         "phi35_moe_42b", "deepseek_v3_671b", "whisper_tiny", "qwen3_32b",
         "chameleon_34b", "zamba2_7b", "xlstm_125m"]


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (ported: {ARCHS})")
    return importlib.import_module(f"{__name__}.{name}")


def get(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
