"""What one kernel launch costs: its FLOPs by operand type and its HBM bytes.

Each kernel package's ``ops.cost(wrapper, *args, **kwargs)`` prices one
call of a wrapper (a name in ``ops.COSTED``) on the wrapper's own
arguments: the list of its launches as (kernel, {operand type: FLOPs},
bytes), each input read once and each output written once, and only the
work the data needs (the (query, key) pairs a mask keeps, the cache
columns a sequence reads).  ``chip_smoke.py``'s ``bound_ms`` and the
planner (``launch/dryrun.py``) both read it.  On ``meta`` tensors (the
planner's) no value can be read: a data-dependent count takes the most
the shapes allow (every column from 0 up to the query live, every page
mapped).
"""

from __future__ import annotations

import numpy as np
import torch


def nbytes(*ts) -> int:
    """Bytes of the tensors ``ts`` (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def op_type(dtype) -> str:
    """The peak a product of ``dtype`` operands runs at: "bf16", "int8"
    or "f32" (``core/roofline.py``'s keys)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "f32"


def known(*ts) -> bool:
    """Whether the values of ``ts`` can be read (no ``meta`` tensor)."""
    return all(t is None or t.device.type != "meta" for t in ts)


def band_pairs(sq: int, skv: int, off: int, causal: bool, window) -> int:
    """(query, key) pairs a causal / windowed band keeps: query row t at
    key position ``off + t``."""
    t = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, off + t) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, off + t - int(window) + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def band_columns(sq: int, skv: int, off: int, causal: bool, window) -> int:
    """Key columns some query row of the band attends (one interval)."""
    hi = min(skv - 1, off + sq - 1) if causal else skv - 1
    lo = max(0, off - int(window) + 1) if window else 0
    return max(hi - lo + 1, 0)


def plane_matmul(kernel: str, planes: int, x, w, scale_x, scale_w, out_dtype):
    """Kernels 1, 4, 5 and 6: ``planes`` int8 products of X [M, K] by
    [K, N]; X, the planes and both scales read, the output written."""
    m, k = x.shape
    n = w.shape[-1]
    return (kernel, {"int8": planes * 2 * m * k * n},
            nbytes(x, w, scale_x, scale_w) + m * n * out_dtype.itemsize)
