"""Device resolution for the port's entry points: no silent fallback.

Entry points take ``device=None`` and run on the CUDA card; a caller
that wants the CPU (the tests) says so with ``device="cpu"``.  Asking
for CUDA on a machine without a card raises instead of quietly running
the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
