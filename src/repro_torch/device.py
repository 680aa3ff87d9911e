"""Device resolution for the port's entry points: no silent fallback.

Entry points take ``device=None`` and run on the CUDA card; a caller
that wants the CPU (the tests) says so with ``device="cpu"``.  Asking
for CUDA on a machine without a card raises instead of quietly running
the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import numpy as np
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


def upload(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """A new tensor on ``device`` holding the host array ``arr`` (cast to
    numpy ``dtype`` when given), copied without a stream sync.

    A pageable host->device copy with ``non_blocking=False`` waits for
    every kernel already queued on the stream.  On the card the array is
    staged in pinned memory and copied with ``non_blocking=True``; the
    staging block comes from PyTorch's caching host allocator, which
    records an event on the copy and hands the block out again only
    after that event, so a later upload never overwrites bytes still in
    flight.  On the CPU: a copy (never a view of ``arr``)."""
    t = torch.from_numpy(np.array(arr, dtype=dtype))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
