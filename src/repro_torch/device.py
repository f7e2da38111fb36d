"""Where the port's entry points run: on CUDA unless the caller names a
device.  None never falls back to the CPU by itself.  A process launched
as one rank of a run (``launch.distributed.launched``) runs on its own
card, ``cuda:LOCAL_RANK``."""
from __future__ import annotations

import torch

from .launch import distributed


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
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and distributed.launched()):
        return torch.device("cuda", distributed.local_rank())
    return device
