"""Where the port's entry points run: on CUDA unless the caller names a
device.  None never falls back to the CPU by itself."""
from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """``device`` as a torch.device; None means CUDA, and raises when no
    CUDA device is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA by default and no CUDA device is "
                f"available; pass device='cpu' (--device cpu on the command "
                f"line) to run on the CPU")
        device = "cuda"
    return torch.device(device)
