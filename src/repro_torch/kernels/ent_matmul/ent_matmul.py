"""Wrappers of the CUDA kernels in ``csrc/ent_matmul.cu``, the EN-T
digit-plane matmuls (replacing the Pallas kernels of
``repro/kernels/ent_matmul/ent_matmul.py``):

* ``ent_matmul_packed_fused`` (``:227``): packed planes, X quantized in
  the kernel's prologue;
* ``ent_matmul_packed`` (``:205``): packed planes, pre-quantized int8 X;
* ``ent_matmul`` (``:75``): the legacy 4-plane form, int8 X.

On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch version.  Each wrapper's ``launches``
counts its kernel launches.  All three, like ``int8_matmul`` (kernel 6),
route by M, each with its own cut (``M_STREAM`` for kernel 1,
``M_STREAM_PACKED`` for kernel 4, ``M_STREAM_PLANES`` for kernel 5,
kernel 6's in its own module): up to the cut (the decode shape) the
split-K weight stream of ``csrc/int8_stream.cuh``, counted in
``.stream_launches``; above, the int8 tensor-core loop of
``csrc/int8_tc.cuh``, counted in ``.tc_launches``, both among their
``.launches``.  The route and its knobs (the stream's rows a block and K
slice, the tensor-core loop's K slice) come from ``kernels/tuning``,
whose heuristic is ``route_of`` by the wrapper's cut, ``stream_plan``
and ``tc_plan``: an empty table launches as those do.  ``out_dtype`` is
float32 (the default, as in the reference), bfloat16, or int32 for the
int32 accumulator itself (no epilogue: the quantity the ``*_int32_ref``
oracles return).
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import NUM_PACKED_PLANES, PACKED_MAX_K
from repro_torch.kernels import _build, tuning
from repro_torch.kernels.ent_matmul.ref import (ent_matmul_int32_ref, ent_matmul_ref,
                                                ent_packed_matmul_int32_ref,
                                                ent_packed_matmul_ref,
                                                quantize_with_scale)

NUM_PLANES = 4
# the kernels' output kinds (csrc/int8_common.cuh, OutKind)
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
# Kernel 4 (packed planes, int8 X) has its own cut, from the same table
# for kernel 4: it reads kernel 1's plane bytes, but its tensor-core loop
# has no quantizer and is the faster from M = 16 on.
M_STREAM_PACKED = 8
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
    return _launch_fused(x, packed, scale_x, scale_w, out_dtype,
                         table_route("ent_matmul_packed_fused", x, m, n, k, M_STREAM))


def route_of(m: int, cut: int | None = None) -> str:
    """The route kernel 1 takes at ``m`` rows, or kernel 4, 5 or 6 with
    its own ``cut``: the stream up to the cut, the tensor-core loop above."""
    return "stream" if m <= (M_STREAM if cut is None else cut) else "tc"


def table_route(family: str, x, m: int, n: int, k: int, cut: int) -> str:
    """The route of a launch of kernel ``family`` (1, 4, 5 or 6) on card
    operands: ``kernels/tuning``'s plan, which is ``route_of(m, cut)``
    unless the table holds another (an empty table needs no SM count)."""
    if tuning.empty():
        return route_of(m, cut)
    return tuning.get_block_config(family, (m, k, n), sms=_build.sm_count(x.device),
                                   cut=cut)["route"]


def tc_bm(family: str) -> int:
    """Rows a tensor-core block of kernel ``family`` (1, 4, 5 or 6)."""
    return TC_BM_PLANES if family == "ent_matmul" else TC_BM


_FUSED_ENTRIES = {"stream": "ent_matmul_packed_fused_stream",
                  "tc": "ent_matmul_packed_fused_tc"}


def _launch_fused(x, packed, scale_x, scale_w, out_dtype, route: str, plan=None):
    """Launch kernel 1 on checked card operands through ``route``
    ("stream" or "tc"), ``plan`` overriding the table's knobs; the wrapper
    chooses by M, chip_smoke.py calls this to time the two loops at one M
    and to tune."""
    m, k = x.shape
    n = packed.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lead = (x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale_x.data_ptr(), scale_w.data_ptr(), out.data_ptr(), OUT_KINDS[out_dtype])
    rc = launch_route("ent_matmul_packed_fused", "ent_matmul", _FUSED_ENTRIES, lead, x, m, n, k,
                      route, plan)
    _build.check(rc, "ent_matmul_packed_fused")
    count_launch(ent_matmul_packed_fused, route)
    return out


def launch_route(family, source, entries, lead, x, m, n, k, route: str, overrides=None) -> int:
    """Call ``route``'s C entry point of ``csrc/<source>.cu`` (``entries``:
    route -> name) with the operand arguments ``lead``, then, for the
    stream and the tensor-core loop, the split-K workspace and tickets
    (None, 0 when K is not split), the shape and the route's plan, which
    ``kernels/tuning`` resolves for kernel ``family`` (``overrides`` win);
    returns the entry point's error code."""
    if route not in entries:
        raise ValueError(f"route must be one of {tuple(entries)}, got {route!r}")
    cuda_stream = _build.stream_of(x)
    fn = _build.entry(source, entries[route])
    dev = x.device
    cfg = tuning.get_block_config(family, (m, k, n), overrides, sms=_build.sm_count(dev),
                                  route=route)
    kslice = cfg["kslice"]
    if route == "stream":
        splits = -(-k // kslice)
        plan, tickets = (cfg["mb"], kslice, splits), -(-n // STREAM_BN) * -(-m // cfg["mb"])
    else:
        splits = max(1, -(-k // kslice))
        plan, tickets = (kslice, splits), -(-m // tc_bm(family)) * -(-n // TC_BN)
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
    return _launch_packed(x, packed, scale_x, scale_w, out_dtype,
                          table_route("ent_matmul_packed", x, m, n, k, M_STREAM_PACKED))


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
    return _launch_planes(x, planes, scale_x, scale_w, out_dtype,
                          table_route("ent_matmul", x, m, n, k, M_STREAM_PLANES))


_PACKED_ENTRIES = {"stream": "ent_matmul_packed_stream", "tc": "ent_matmul_packed_tc"}
_PLANES_ENTRIES = {"stream": "ent_matmul_planes_stream", "tc": "ent_matmul_planes_tc"}


def _launch_packed(x, packed, scale_x, scale_w, out_dtype, route: str):
    """Launch kernel 4 on checked card operands through ``route``
    ("stream" or "tc"); the wrapper chooses by M, chip_smoke.py calls this
    to time the two loops at one M."""
    return _launch_int8_x(ent_matmul_packed, _PACKED_ENTRIES, x, packed, scale_x, scale_w,
                          out_dtype, route)


def _launch_planes(x, planes, scale_x, scale_w, out_dtype, route: str):
    """Launch kernel 5 on checked card operands through ``route``
    ("stream" or "tc"), as ``_launch_packed`` does kernel 4."""
    return _launch_int8_x(ent_matmul, _PLANES_ENTRIES, x, planes, scale_x, scale_w, out_dtype,
                          route)


def _launch_int8_x(wrapper, entries, x, planes, scale_x, scale_w, out_dtype, route):
    """Kernel 4 or 5 (int8 X, ``wrapper``'s planes) through ``route``'s
    entry of ``entries``; counted on ``wrapper``."""
    m, k = x.shape
    n = planes.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lead = (x.data_ptr(), planes.data_ptr(), scale_x.data_ptr(), scale_w.data_ptr(),
            out.data_ptr(), OUT_KINDS[out_dtype])
    rc = launch_route(wrapper.__name__, "ent_matmul", entries, lead, x, m, n, k, route)
    _build.check(rc, wrapper.__name__)
    count_launch(wrapper, route)
    return out


ent_matmul_packed_fused.launches = 0
ent_matmul_packed_fused.stream_launches = 0
ent_matmul_packed_fused.tc_launches = 0
ent_matmul_packed.launches = 0
ent_matmul_packed.stream_launches = 0
ent_matmul_packed.tc_launches = 0
ent_matmul.launches = 0
ent_matmul.stream_launches = 0
ent_matmul.tc_launches = 0
