"""Wrappers of the CUDA kernels in ``csrc/ent_matmul.cu``, the EN-T
digit-plane matmuls (replacing the Pallas kernels of
``repro/kernels/ent_matmul/ent_matmul.py``):

* ``ent_matmul_packed_fused`` (``:227``): packed planes, X quantized in
  the kernel's prologue;
* ``ent_matmul_packed`` (``:205``): packed planes, pre-quantized int8 X;
* ``ent_matmul`` (``:75``): the legacy 4-plane form, int8 X.

On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch version.  Each wrapper's ``launches``
counts its kernel launches.  ``ent_matmul_packed_fused`` (kernel 1) and
``ent_matmul`` (kernel 5), like ``int8_matmul`` (kernel 6), route by M:
up to their cut (the decode shape; ``M_STREAM`` for kernel 1,
``M_STREAM_PLANES`` for kernel 5, kernel 6's in its own module) the
split-K weight stream of ``csrc/int8_stream.cuh``, counted in
``.stream_launches``; above, the int8 tensor-core loop of
``csrc/int8_tc.cuh``, counted in ``.tc_launches``, both among their
``.launches``.  The CUDA-core tile loop of ``csrc/int8_tile.cuh`` serves
``ent_matmul_packed`` (kernel 4, which no serving or training path
launches); ``chip_smoke.py`` times it beside the two routes.
``out_dtype`` is float32 (the default, as in the reference), bfloat16, or
int32 for the int32 accumulator itself (no epilogue: the quantity the
``*_int32_ref`` oracles return).
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import NUM_PACKED_PLANES, PACKED_MAX_K
from repro_torch.kernels import _build
from repro_torch.kernels.ent_matmul.ref import (ent_matmul_int32_ref, ent_matmul_ref,
                                                ent_packed_matmul_int32_ref,
                                                ent_packed_matmul_ref,
                                                quantize_with_scale)

NUM_PLANES = 4
# the kernels' output kinds (csrc/int8_tile.cuh, OutKind)
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

# Kernel 1 takes the split-K weight stream up to M_STREAM rows, the
# tensor-core loop above: the largest M of chip_smoke.py's check_cut table
# for kernel 1 (M = 8, 16, 32, 64, 96, 128) up to which the stream takes
# less time than the tensor-core loop over a layer's seven qwen2.5-3b
# projections (PERF.md).  Kernel 6 has its own cut (int8_matmul.py).
M_STREAM = 16
# Kernel 5 (the legacy 4-plane records) has its own cut, from the same
# table for kernel 5: at four planes the stream reads twice kernel 1's
# bytes, and the tensor-core loop is the faster from M = 16 on.
M_STREAM_PLANES = 8
# the stream's strip width, K-slice step and cap, and rows a block
# (csrc/int8_stream.cuh: BN, KSTEP; the instantiated MB: larger M runs in
# chunks of 8 rows): the plan is made here, and the launcher refuses one
# that does not fit its own constants
STREAM_BN = 64
STREAM_KSTEP = 16
STREAM_KSLICE_MAX = 2048
STREAM_MB = (4, 8)
# the tensor-core loop's output tile and k step (csrc/int8_tc.cuh: BM, BN,
# BK; bm<4>, the rows of a block at four planes), and the fewest k steps a
# K slice of it takes
TC_BM = 128
TC_BM_PLANES = 64
TC_BN = 128
TC_BK = 128
TC_MIN_STEPS = 2


def stream_plan(m: int, n: int, k: int, sms: int):
    """The stream's launch plan for X [m, k] x planes [., k, n] on a card
    of ``sms`` SMs: (mb rows a block, kslice rows a K slice, splits, grid
    (strips, splits, M chunks)).  K slices are multiples of STREAM_KSTEP
    rows, and as many as it takes for at least 2 blocks per SM where K
    allows it; the last slice may be shorter."""
    mb = next(b for b in STREAM_MB if b >= min(m, STREAM_MB[-1]))
    chunks = -(-m // mb)
    strips = -(-n // STREAM_BN)
    splits = max(1, -(-2 * sms // (strips * chunks)))
    kslice = k // splits // STREAM_KSTEP * STREAM_KSTEP
    kslice = max(STREAM_KSTEP, min(STREAM_KSLICE_MAX, kslice,
                                   -(-k // STREAM_KSTEP) * STREAM_KSTEP))
    splits = -(-k // kslice)
    return mb, kslice, splits, (strips, splits, chunks)


def tc_plan(m: int, n: int, k: int, sms: int, bm: int = TC_BM):
    """The tensor-core loop's launch plan for X [m, k] x planes [., k, n]
    on a card of ``sms`` SMs (one block an SM) with ``bm`` rows a block
    (TC_BM_PLANES at four planes): (kslice rows a K slice, splits, grid (M
    tiles, N tiles, splits)).  Where the output tiles fill
    more than half the SMs, K is not split; otherwise it is cut into as
    many slices of whole TC_BK steps (TC_MIN_STEPS at least) as fit in one
    wave, since a split that spills into a second wave takes longer than
    none.  The last slice may be shorter."""
    tiles = -(-m // bm) * -(-n // TC_BN)
    steps = max(1, -(-k // TC_BK))
    splits = 1
    if 2 * tiles <= sms:
        splits = max(1, min(sms // tiles, steps // TC_MIN_STEPS))
    kslice = -(-steps // splits) * TC_BK
    splits = max(1, -(-k // kslice))
    return kslice, splits, (-(-m // bm), -(-n // TC_BN), splits)


def check_operands(x, w, scale_x, scale_w, out_dtype, *, x_dtypes, planes,
                   max_k):
    """Validate ``x [M, K]``, weight planes ``w [planes, K, N]`` (or
    ``[K, N]`` with ``planes=None``) and the scales; returns (M, N, K)."""
    m, k = x.shape
    if planes is None:
        ok = w.dim() == 2 and w.shape[0] == k
    else:
        ok = w.dim() == 3 and w.shape[0] == planes and w.shape[1] == k
    if not ok:
        raise ValueError(f"weight {tuple(w.shape)} does not match X {tuple(x.shape)}"
                         f" ({planes or 'no'} planes)")
    n = w.shape[-1]
    if k > max_k:
        raise ValueError(f"K={k} exceeds {max_k} (int32 overflow bound)")
    if x.dtype not in x_dtypes:
        raise TypeError(f"X must be one of {x_dtypes}, got {x.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {w.dtype}")
    if scale_x.shape != (m, 1) or scale_w.shape != (1, n):
        raise ValueError(f"scales {tuple(scale_x.shape)}, {tuple(scale_w.shape)} "
                         f"do not match M={m}, N={n}")
    if scale_x.dtype != torch.float32 or scale_w.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be one of {tuple(OUT_KINDS)}, got {out_dtype}")
    for t in (x, w, scale_x, scale_w):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return m, n, k


def ent_matmul_packed_fused(x, packed, scale_x, scale_w, out_dtype=torch.float32):
    """X [M, K] f32/bf16, packed planes int8 [2, K, N], per-row scale
    sx f32 [M, 1] (amax/127, computed by the caller), per-channel sw f32
    [1, N] -> [M, N]: ``(float(Xq @ P0 + (Xq @ P1 << 4)) * sx) * sw``
    with ``Xq = clip(rint(X / sx), -127, 127)``."""
    m, n, k = check_operands(x, packed, scale_x, scale_w, out_dtype,
                             x_dtypes=(torch.float32, torch.bfloat16),
                             planes=NUM_PACKED_PLANES, max_k=PACKED_MAX_K)
    if x.device.type == "cpu":
        xq = quantize_with_scale(x, scale_x)
        if out_dtype == torch.int32:
            return ent_packed_matmul_int32_ref(xq, packed)
        return ent_packed_matmul_ref(xq, packed, scale_x, scale_w, out_dtype)
    return _launch_fused(x, packed, scale_x, scale_w, out_dtype, route_of(m))


def route_of(m: int, cut: int | None = None) -> str:
    """The route kernel 1 takes at ``m`` rows, or kernel 6 with its own
    ``cut``: the stream up to the cut, the tensor-core loop above."""
    return "stream" if m <= (M_STREAM if cut is None else cut) else "tc"


_FUSED_ENTRIES = {"stream": "ent_matmul_packed_fused_stream",
                  "tc": "ent_matmul_packed_fused_tc", "tile": "ent_matmul_packed_fused"}


def _launch_fused(x, packed, scale_x, scale_w, out_dtype, route: str):
    """Launch kernel 1 on checked card operands through ``route``
    ("stream", "tc" or "tile"); the wrapper chooses by M, chip_smoke.py
    calls this to time the three loops at one M."""
    m, k = x.shape
    n = packed.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lead = (x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale_x.data_ptr(), scale_w.data_ptr(), out.data_ptr(), OUT_KINDS[out_dtype])
    rc = launch_route("ent_matmul", _FUSED_ENTRIES, lead, x, m, n, k, route)
    _build.check(rc, "ent_matmul_packed_fused")
    count_launch(ent_matmul_packed_fused, route)
    return out


def launch_route(source, entries, lead, x, m, n, k, route: str, tc_bm: int = TC_BM) -> int:
    """Call ``route``'s C entry point of ``csrc/<source>.cu`` (``entries``:
    route -> name) with the operand arguments ``lead``, then, for the
    stream and the tensor-core loop (``tc_bm`` rows a block), the split-K
    workspace and tickets (None, 0 when K is not split), the shape and the
    route's plan; returns the entry point's error code."""
    if route not in entries:
        raise ValueError(f"route must be one of {tuple(entries)}, got {route!r}")
    cuda_stream = _build.stream_of(x)
    fn = _build.entry(source, entries[route])
    if route == "tile":
        return fn(*lead, m, n, k, cuda_stream)
    dev = x.device
    if route == "stream":
        mb, kslice, splits, (strips, _, chunks) = stream_plan(m, n, k, _build.sm_count(dev))
        plan, tickets = (mb, kslice, splits), strips * chunks
    else:
        kslice, splits, (mt, nt, _) = tc_plan(m, n, k, _build.sm_count(dev), tc_bm)
        plan, tickets = (kslice, splits), mt * nt
    ws = tk = None
    if splits > 1:
        ws, tk = _build.stream_workspace((dev, cuda_stream), m * n, tickets)
    return fn(*lead, None if ws is None else ws.data_ptr(), 0 if ws is None else ws.numel(),
              None if tk is None else tk.data_ptr(), 0 if tk is None else tk.numel(),
              m, n, k, *plan, cuda_stream)


def count_launch(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.stream_launches += route == "stream"
    wrapper.tc_launches += route == "tc"


def ent_matmul_packed(x, packed, scale_x, scale_w, out_dtype=torch.float32):
    """int8 X [M, K], packed planes int8 [2, K, N], sx f32 [M, 1], sw f32
    [1, N] -> [M, N]: ``(float(X @ P0 + (X @ P1 << 4)) * sx) * sw``."""
    m, n, k = check_operands(x, packed, scale_x, scale_w, out_dtype, x_dtypes=(torch.int8,),
                             planes=NUM_PACKED_PLANES, max_k=PACKED_MAX_K)
    if x.device.type == "cpu":
        if out_dtype == torch.int32:
            return ent_packed_matmul_int32_ref(x, packed)
        return ent_packed_matmul_ref(x, packed, scale_x, scale_w, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        _launch_tile_planes(x, packed, scale_x, scale_w, out)
        ent_matmul_packed.launches += 1
    return out


def _launch_tile_planes(x, planes, scale_x, scale_w, out):
    """Kernel 4 or 5 (by the planes' count) on the CUDA-core tile loop."""
    m, k = x.shape
    n = planes.shape[-1]
    rc = _build.entry("ent_matmul", "ent_matmul_planes")(
        x.data_ptr(), planes.data_ptr(), planes.shape[0], scale_x.data_ptr(),
        scale_w.data_ptr(), out.data_ptr(), OUT_KINDS[out.dtype], m, n, k,
        _build.stream_of(x))
    _build.check(rc, "ent_matmul_planes")


def ent_matmul(x, planes, scale_x, scale_w, out_dtype=torch.float32):
    """int8 X [M, K], digit planes int8 [4, K, N] in {-2..2}, sx f32
    [M, 1], sw f32 [1, N] -> [M, N]:
    ``(float(sum_i (X @ P_i) << 2i) * sx) * sw``."""
    m, n, k = check_operands(x, planes, scale_x, scale_w, out_dtype, x_dtypes=(torch.int8,),
                             planes=NUM_PLANES, max_k=PACKED_MAX_K)
    if x.device.type == "cpu":
        if out_dtype == torch.int32:
            return ent_matmul_int32_ref(x, planes)
        return ent_matmul_ref(x, planes, scale_x, scale_w, out_dtype)
    return _launch_planes(x, planes, scale_x, scale_w, out_dtype, route_of(m, M_STREAM_PLANES))


_PLANES_ENTRIES = {"stream": "ent_matmul_planes_stream", "tc": "ent_matmul_planes_tc"}


def _launch_planes(x, planes, scale_x, scale_w, out_dtype, route: str):
    """Launch kernel 5 on checked card operands through ``route``
    ("stream", "tc" or "tile"); the wrapper chooses by M, chip_smoke.py
    calls this to time the three loops at one M."""
    m, k = x.shape
    n = planes.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if route == "tile":
        _launch_tile_planes(x, planes, scale_x, scale_w, out)
    else:
        lead = (x.data_ptr(), planes.data_ptr(), scale_x.data_ptr(), scale_w.data_ptr(),
                out.data_ptr(), OUT_KINDS[out_dtype])
        rc = launch_route("ent_matmul", _PLANES_ENTRIES, lead, x, m, n, k, route,
                          TC_BM_PLANES)
        _build.check(rc, "ent_matmul")
    count_launch(ent_matmul, route)
    return out


ent_matmul_packed_fused.launches = 0
ent_matmul_packed_fused.stream_launches = 0
ent_matmul_packed_fused.tc_launches = 0
ent_matmul_packed.launches = 0
ent_matmul.launches = 0
ent_matmul.stream_launches = 0
ent_matmul.tc_launches = 0
