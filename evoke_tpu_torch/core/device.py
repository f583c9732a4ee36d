"""Device resolution without fallback.

Every entry point of the port takes ``device`` (default ``"cuda"``). When CUDA
is absent the call raises: a run that asked for the card must never quietly
measure the CPU. Pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
    return dev
