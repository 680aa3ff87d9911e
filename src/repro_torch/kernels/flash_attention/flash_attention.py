"""Wrappers of the CUDA kernels in ``csrc/flash_attention.cu``:

* ``flash_attention_masked``: masked flash prefill (kernel 2, replaces
  the Pallas ``flash_attention_masked``,
  ``repro/kernels/flash_attention/flash_attention.py:145``);
* ``flash_attention``: the training forward (kernel 7, replaces the
  Pallas ``flash_attention``, ``flash_attention.py:92``), which also
  returns each row's log-sum-exp;
* ``flash_attention_bwd_dkdv`` and ``flash_attention_bwd_dq``: its
  backward (kernels 7b and 7c; the reference has no backward kernel),
  run together by ``flash_attention_bwd``.

On a CUDA tensor each wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch version.  Each kernel wrapper's
``.launches`` counts its kernel's launches.

Kernels 2, 7, 7b and 7c take one of two routes by the operands' dtype
(:func:`route`), with no fallback: bfloat16 (what serving and training
run) the tensor-core kernels (``wgmma`` + TMA), float32 the CUDA-core
ones.  Each wrapper's ``.tc_launches`` counts the tensor-core launches
among its ``.launches`` (and kernel 2's ``.offset_launches`` those with
per-sequence offsets).  On the tensor-core route kernel 7c also writes
D_i = rowsum(dO * O), which ``flash_attention_bwd`` hands to 7b
(``delta=``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_ref, masked_attention_ref)

HEAD_DIMS = (64, 128)
# kernels 2, 7, 7b and 7c: operand dtype -> route
ROUTES = {torch.bfloat16: "tensor-core", torch.float32: "cuda-core"}


def route(dtype, head_dim: int) -> str:
    """The route kernels 2, 7, 7b and 7c take for ``dtype`` operands of
    ``head_dim``; raises for what neither route takes."""
    if dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    return ROUTES[dtype]


def _check_qkv(q, k, v):
    b, hq, _, d = q.shape
    _, hkv, _, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")


def _check_cuda(q, *tensors):
    """Dtype, head_dim, device and contiguity checks for a kernel launch;
    ``tensors`` must share q's dtype.  The tensor-core route reads them by
    TMA and 16-byte loads, which need 16-byte-aligned bases."""
    tc = route(q.dtype, q.shape[3]) == "tensor-core"
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"operands must share q's dtype {q.dtype}, got {t.dtype}")
    for t in (q, *tensors):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
        if tc and t.data_ptr() % 16:
            raise ValueError("tensor-core route: operands must be 16-byte aligned")


def _mask_args(sq, skv, d, causal, window, scale, q_offset):
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    return (skv - sq if q_offset is None else int(q_offset), int(causal),
            0 if window is None else int(window), d**-0.5 if scale is None else float(scale))


def flash_attention_masked(q, k, v, start, *, q_offset: int = 0, q_offsets=None,
                           causal: bool = True, window: int | None = None,
                           scale: float | None = None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (f32 or bf16, one dtype),
    start int32 [B] -> [B, Hq, Sq, D] in q's dtype (as the Pallas kernel;
    softmax and accumulation in f32).  Query row t of sequence b sits at
    kv position ``q_offset + t``, or ``q_offsets[b] + t`` when the int32
    [B] ``q_offsets`` is given (a verify burst, a dense decode read).  The
    bfloat16 (tensor-core) route rounds P to bf16 relative to the running
    max after each 64-column kv tile (64-row q tiles)."""
    _check_qkv(q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if start.shape != (b,) or start.dtype != torch.int32:
        raise ValueError("start must be int32 [B]")
    if q_offsets is not None and (q_offsets.shape != (b,) or q_offsets.dtype != torch.int32):
        raise ValueError("q_offsets must be int32 [B]")
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, start=start, q_offset=q_offset,
                                    q_offsets=q_offsets, causal=causal, window=window,
                                    scale=scale).to(q.dtype)
    _check_cuda(q, k, v)
    for t in (start, q_offsets):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("operands must be contiguous and on one device")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if b * hq * sq == 0:
        return out
    fn = _build.entry("flash_attention", "flash_attention_masked")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
            None if q_offsets is None else q_offsets.data_ptr(),
            out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, sq,
            skv, d, int(q_offset), int(causal),
            0 if window is None else int(window), float(scale),
            _build.stream_of(q))
    _build.check(rc, "flash_attention_masked")
    flash_attention_masked.launches += 1
    flash_attention_masked.tc_launches += route(q.dtype, d) == "tensor-core"
    flash_attention_masked.offset_launches += q_offsets is not None
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_offset: int | None = None):
    """Training forward.  q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (f32 or
    bf16, one dtype) -> (out [B, Hq, Sq, D] in q's dtype, lse float32
    [B, Hq, Sq]).  Query row t sits at kv position ``q_offset + t``
    (default ``Skv - Sq``, as the Pallas kernel).  The plain version and
    the float32 route keep the probabilities in f32; the bfloat16
    (tensor-core) route rounds them to bf16 for the value product."""
    _check_qkv(q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    off, c, w, sc = _mask_args(sq, skv, d, causal, window, scale, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=sc, q_offset=off)
    _check_cuda(q, k, v)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b * hq * sq == 0:
        return out, lse
    fn = _build.entry("flash_attention", "flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, sq, skv,
            d, off, c, w, sc, _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.tc_launches += route(q.dtype, d) == "tensor-core"
    return out, lse


def _check_bwd(q, k, v, o, lse, do):
    _check_qkv(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
                         f"q's {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}")


def _bwd_launch(fname, outs, q, k, v, o, lse, do, causal, window, scale,
                q_offset, delta=(), delta_out=()):
    """Launch ``fname``; ``delta`` is the dK/dV entry point's extra input
    and ``delta_out`` the dQ entry point's extra output (a tensor, or None
    for the float32 route)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    off, c, w, sc = _mask_args(sq, skv, d, causal, window, scale, q_offset)
    _check_cuda(q, k, v, o, do)
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError("operands must be contiguous and on one device")
    if b * hq * sq == 0 or skv == 0:
        for t in (*outs, *(t for t in delta_out if t is not None)):
            t.zero_()
        return False
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    fn = _build.entry("flash_attention", fname)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *map(ptr, delta), do.data_ptr(),
            *(t.data_ptr() for t in outs), *map(ptr, delta_out),
            int(q.dtype == torch.bfloat16), b, hq, hkv, sq, skv, d, off, c, w,
            sc, _build.stream_of(q))
    _build.check(rc, fname)
    return True


def bwd_delta(o, do):
    """D_i = rowsum(dO_i * O_i), float32 [B, Hq, Sq]: the row term of the
    backward.  Kernel 7c's tensor-core route writes it as a by-product;
    this plain version serves CPU tensors and a standalone call of 7b."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1)


def flash_attention_bwd_dkdv(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None,
                             q_offset: int | None = None, delta=None):
    """(dk, dv) [B, Hkv, Skv, D] in k's dtype, summed over each kv head's
    group of q heads, from the forward's output ``o`` and ``lse`` and the
    output gradient ``do`` (q's shape and dtype).  The bfloat16
    (tensor-core) route reads D_i from ``delta`` (float32 [B, Hq, Sq], as
    kernel 7c writes it), or from :func:`bwd_delta` when it is None, and
    rounds P and dS to bf16 for the dV and dK products; the float32 route
    computes D_i itself."""
    _check_bwd(q, k, v, o, lse, do)
    if delta is not None and (delta.shape != q.shape[:3] or delta.dtype != torch.float32
                              or delta.device != q.device):
        raise ValueError(f"delta must be float32 {tuple(q.shape[:3])} on q's device")
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                            window=window, scale=scale,
                                            q_offset=q_offset,
                                            delta=bwd_delta(o, do) if delta is None else delta)
        return dk, dv
    tc = route(q.dtype, q.shape[3]) == "tensor-core"
    if tc:
        delta = (bwd_delta(o, do) if delta is None else delta).contiguous()
    else:
        delta = None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_launch("flash_attention_bwd_dkdv", (dk, dv), q, k, v, o, lse, do,
                   causal, window, scale, q_offset, delta=(delta,)):
        flash_attention_bwd_dkdv.launches += 1
        flash_attention_bwd_dkdv.tc_launches += tc
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           window: int | None = None,
                           scale: float | None = None,
                           q_offset: int | None = None,
                           return_delta: bool = False):
    """dq [B, Hq, Sq, D] in q's dtype (arguments as
    :func:`flash_attention_bwd_dkdv`).  With ``return_delta``, (dq, delta):
    D_i = rowsum(dO * O), float32 [B, Hq, Sq], as the tensor-core route
    writes it in the same pass (:func:`bwd_delta` on CPU tensors; None on
    the float32 route, whose 7b computes its own)."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        dq = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                     window=window, scale=scale,
                                     q_offset=q_offset)[0]
        return (dq, bwd_delta(o, do)) if return_delta else dq
    tc = route(q.dtype, q.shape[3]) == "tensor-core"
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if tc else None
    if _bwd_launch("flash_attention_bwd_dq", (dq,), q, k, v, o, lse, do,
                   causal, window, scale, q_offset, delta_out=(delta,)):
        flash_attention_bwd_dq.launches += 1
        flash_attention_bwd_dq.tc_launches += tc
    return (dq, delta) if return_delta else dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        q_offset: int | None = None):
    """(dq, dk, dv) of :func:`flash_attention`: kernel 7c, then 7b with the
    D_i that 7c wrote, on CUDA tensors; ``flash_attention_bwd_ref`` on CPU
    tensors."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        _check_bwd(q, k, v, o, lse, do)
        return flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, return_delta=True, **kw)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, o, lse, do, delta=delta, **kw)
    return dq, dk, dv


flash_attention_masked.launches = 0
flash_attention_masked.tc_launches = 0
flash_attention_masked.offset_launches = 0
flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dkdv.tc_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0
