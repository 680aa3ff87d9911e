"""Wrappers of the CUDA kernels in ``csrc/ssd_scan.cu``:

* ``ssd_scan``: the chunked SSD scan (kernel 8, replaces the Pallas
  ``ssd_scan``, ``repro/kernels/ssd_scan/ssd_scan.py:72``), which with
  ``save_states`` also returns each chunk's entering state.  One call is
  three launches: each chunk's own state (``states``), the carry from
  chunk to chunk (``carry``) and the outputs (``out``);
* ``ssd_prefill``: kernel 8's prefill form (row 8p), the SSM prompt
  recurrence of serving: the same three launches entered from the slot's
  state ``h_init`` [B, H, P, N] and returning the state leaving the
  prompt beside y.  Pads (``mask`` False) get dt = 0, which leaves the
  state as it was; a length past one chunk that the chunk does not divide
  is left-padded with zero rows (dt = 0 too) to the next multiple;
* ``ssd_scan_bwd_state`` and ``ssd_scan_bwd_chunk``: its backward
  (kernels 8b and 8c; the reference has no backward kernel), run
  together by ``ssd_scan_bwd``.  Kernel 8b is two launches in kernel 8's
  form: each chunk's own term (``own``) and the carry from the last chunk
  to the first (``carry``).

On a CUDA tensor each wrapper launches its kernels or raises; only CPU
tensors take the plain PyTorch version.  The kernels take float32
operands, P = 64, N = 128 and chunks of at most 128 steps; kernels 8, 8b
and 8c run their chunk products on the tensor cores in split-bf16
three-pass form (``csrc/ssd_scan.cu`` has the error budget;
``ref.split_bf16_einsum`` emulates it).  Each kernel wrapper's
``.launches`` counts its calls, ``ssd_scan.<part>_launches`` and
``ssd_prefill.<part>_launches`` each of the three launches of kernel 8
and of 8p, and ``ssd_scan_bwd_state.<part>_launches`` each of 8b's two.
``fault`` (0 on every path of the port) plants a kernel fault for
``chip_smoke.py``'s checks (see ``csrc/ssd_scan.cu``; 8p's 7 is the
wrapper's: pads keep their dt, so they decay the state); it has no plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import (
    _check, ssd_prefill_ref, ssd_scan_bwd_chunk_ref, ssd_scan_bwd_state_ref,
    ssd_scan_fwd_ref, ssd_scan_ref)

HEAD_DIM, STATE_DIM, MAX_CHUNK = 64, 128, 128


def _check_cuda(*tensors, p, n, chunk):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD kernels take float32 operands, got {t.dtype}")
        if t.device != tensors[0].device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    if (p, n) != (HEAD_DIM, STATE_DIM):
        raise ValueError(f"head_dim {p} / state_dim {n} not supported by the kernels "
                         f"(supported: {HEAD_DIM} / {STATE_DIM})")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")


def _no_fault(fault):
    if fault:
        raise ValueError("fault plants a kernel fault; the plain version has none")


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, save_states: bool = False,
             fault: int = 0):
    """x [B, L, H, P], dt [B, L, H], a [H], b / c [B, L, G, N] -> y f32
    [B, L, H, P], and with ``save_states`` also (y, h0s f32 [B, H, nc, P,
    N]).  ``chunk`` is clamped to L, which it must divide.  On CPU tensors
    y is the reference's CPU route: the per-step recurrence when L <=
    chunk, else the chunk algorithm."""
    bsz, l, h, p, g, n, q = _check(x, dt, a, b, c, chunk)
    nc = l // q
    if x.device.type == "cpu":
        _no_fault(fault)
        if l > q:
            y, h0s = ssd_scan_fwd_ref(x, dt, a, b, c, q)
        else:   # one chunk, entered from the zero state
            y = ssd_scan_ref(x, dt, a, b, c)
            h0s = torch.zeros((bsz, h, 1, p, n), dtype=y.dtype)
        return (y, h0s) if save_states else y
    _check_cuda(x, dt, a, b, c, p=p, n=n, chunk=q)
    y = torch.empty_like(x)
    h0s = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=x.device)
    cumq = torch.empty((bsz, h, nc), dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    rc = _build.entry("ssd_scan", "ssd_fwd_states")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), h0s.data_ptr(),
        cumq.data_ptr(), bsz, l, h, g, p, n, q, stream)
    _build.check(rc, "ssd_fwd_states")
    ssd_scan.states_launches += 1
    rc = _build.entry("ssd_scan", "ssd_fwd_carry")(
        cumq.data_ptr(), h0s.data_ptr(), bsz, l, h, q, fault, stream)
    _build.check(rc, "ssd_fwd_carry")
    ssd_scan.carry_launches += 1
    rc = _build.entry("ssd_scan", "ssd_fwd_out")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        h0s.data_ptr(), y.data_ptr(), bsz, l, h, g, p, n, q, fault, stream)
    _build.check(rc, "ssd_fwd_out")
    ssd_scan.out_launches += 1
    ssd_scan.launches += 1
    return (y, h0s) if save_states else y


def prefill_operands(x, dt, b, c, mask=None, chunk: int = 128, fault: int = 0):
    """The operands 8p runs on: dt zeroed at the pads (``mask`` False;
    not under ``fault`` 7), and, when L passes one chunk and the chunk does
    not divide it, ``pad`` zero rows in front up to the next multiple.
    Returns (x, dt, b, c, pad, the chunk)."""
    bsz, l = x.shape[:2]
    if mask is not None and fault != 7:
        dt = torch.where(mask[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                          device=dt.device))
    pad = 0 if l <= chunk else -l % chunk
    if pad:
        def lpad(t):
            return torch.cat([t.new_zeros((bsz, pad) + tuple(t.shape[2:])), t], dim=1)
        x, dt, b, c = lpad(x), lpad(dt), lpad(b), lpad(c)
    return x, dt, b, c, pad, min(chunk, l + pad)


def ssd_prefill(x, dt, a, b, c, h_init, *, mask=None, chunk: int = 128, fault: int = 0):
    """x [B, L, H, P], dt [B, L, H], a [H], b / c [B, L, G, N], h_init f32
    [B, H, P, N] (the state the prompt enters from), ``mask`` [B, L] bool
    (False: a pad, given dt = 0) -> (y f32 [B, L, H, P], the state leaving
    the prompt f32 [B, H, P, N]).  On CPU tensors the plain version,
    ``ssd_prefill_ref``; on CUDA tensors kernel 8's prefill form, three
    launches, the leaving state written by the carry."""
    bsz, l, h, p, g, n, _ = _check(x, dt, a, b, c)
    if tuple(h_init.shape) != (bsz, h, p, n):
        raise ValueError(f"h_init {tuple(h_init.shape)} must be {(bsz, h, p, n)}")
    x, dt, b, c, pad, q = prefill_operands(x, dt, b, c, mask, chunk, fault)
    if x.device.type == "cpu":
        _no_fault(fault)
        y, h_final = ssd_prefill_ref(x, dt, a, b, c, h_init, q)
        return y[:, pad:], h_final
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    _check_cuda(x, dt, a, b, c, h_init, p=p, n=n, chunk=q)
    lp = l + pad
    nc = lp // q
    y = torch.empty_like(x)
    h0s = torch.empty((bsz, h, nc + 1, p, n), dtype=torch.float32, device=x.device)
    cumq = torch.empty((bsz, h, nc), dtype=torch.float32, device=x.device)
    h_final = torch.empty_like(h_init)
    stream = _build.stream_of(x)
    rc = _build.entry("ssd_scan", "ssd_prefill_states")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), h0s.data_ptr(),
        cumq.data_ptr(), bsz, lp, h, g, p, n, q, stream)
    _build.check(rc, "ssd_prefill_states")
    ssd_prefill.states_launches += 1
    rc = _build.entry("ssd_scan", "ssd_prefill_carry")(
        cumq.data_ptr(), h0s.data_ptr(), h_init.data_ptr(), h_final.data_ptr(), bsz, lp, h, q,
        fault if fault != 7 else 0, stream)
    _build.check(rc, "ssd_prefill_carry")
    ssd_prefill.carry_launches += 1
    rc = _build.entry("ssd_scan", "ssd_prefill_out")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        h0s.data_ptr(), y.data_ptr(), bsz, lp, h, g, p, n, q, stream)
    _build.check(rc, "ssd_prefill_out")
    ssd_prefill.out_launches += 1
    ssd_prefill.launches += 1
    return y[:, pad:], h_final


def ssd_scan_bwd_state(dt, a, c, dy, *, chunk: int = 128, fault: int = 0):
    """dhs f32 [B, H, nc, P, N]: the gradient of the state leaving each
    chunk (zeros for the last), from the output gradient dy [B, L, H, P]."""
    bsz, l, h, p, g, n, q = _check(dy, dt, a, c, c, chunk)
    if dy.device.type == "cpu":
        _no_fault(fault)
        return ssd_scan_bwd_state_ref(dt, a, c, dy, q)
    _check_cuda(dt, a, c, dy, p=p, n=n, chunk=q)
    nc = l // q
    dhs = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=dy.device)
    cumq = torch.empty((bsz, h, nc), dtype=torch.float32, device=dy.device)
    stream = _build.stream_of(dy)
    rc = _build.entry("ssd_scan", "ssd_bwd_own")(
        dt.data_ptr(), a.data_ptr(), c.data_ptr(), dy.data_ptr(), dhs.data_ptr(),
        cumq.data_ptr(), bsz, l, h, g, p, n, q, fault, stream)
    _build.check(rc, "ssd_bwd_own")
    ssd_scan_bwd_state.own_launches += 1
    rc = _build.entry("ssd_scan", "ssd_bwd_carry")(
        cumq.data_ptr(), dhs.data_ptr(), bsz, l, h, q, fault, stream)
    _build.check(rc, "ssd_bwd_carry")
    ssd_scan_bwd_state.carry_launches += 1
    ssd_scan_bwd_state.launches += 1
    return dhs


def ssd_scan_bwd_chunk(x, dt, a, b, c, h0s, dhs, dy, *, chunk: int = 128):
    """(dx [B, L, H, P], ddt [B, L, H], da [H], db, dc [B, L, G, N]), f32,
    from the entering states ``h0s`` and the leaving-state gradients
    ``dhs``.  The kernel writes dB / dC per head and da per (batch row,
    chunk); the sums over each group's heads and over rows and chunks
    are fixed-order ``.sum`` calls here."""
    bsz, l, h, p, g, n, q = _check(x, dt, a, b, c, chunk)
    nc = l // q
    for name, t in (("h0s", h0s), ("dhs", dhs)):
        if tuple(t.shape) != (bsz, h, nc, p, n):
            raise ValueError(f"{name} {tuple(t.shape)} must be {(bsz, h, nc, p, n)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_bwd_chunk_ref(x, dt, a, b, c, h0s, dhs, dy, q)
    _check_cuda(x, dt, a, b, c, h0s, dhs, dy, p=p, n=n, chunk=q)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da_part = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    db_part, dc_part = (torch.empty((bsz, l, h, n), dtype=torch.float32, device=x.device)
                        for _ in range(2))
    rc = _build.entry("ssd_scan", "ssd_scan_bwd_chunk")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        h0s.data_ptr(), dhs.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        da_part.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(), bsz, l, h, g, p,
        n, q, _build.stream_of(x))
    _build.check(rc, "ssd_scan_bwd_chunk")
    ssd_scan_bwd_chunk.launches += 1
    hpg = h // g
    return (dx, ddt, da_part.sum((0, 1)), db_part.view(bsz, l, g, hpg, n).sum(3),
            dc_part.view(bsz, l, g, hpg, n).sum(3))


def ssd_scan_bwd(x, dt, a, b, c, h0s, dy, *, chunk: int = 128):
    """(dx, ddt, da, db, dc) of :func:`ssd_scan`'s y: kernels 8b and 8c on
    CUDA tensors, their plain versions on CPU tensors."""
    dhs = ssd_scan_bwd_state(dt, a, c, dy, chunk=chunk)
    return ssd_scan_bwd_chunk(x, dt, a, b, c, h0s, dhs, dy, chunk=chunk)


ssd_scan.launches = 0
ssd_scan.states_launches = ssd_scan.carry_launches = ssd_scan.out_launches = 0
ssd_prefill.launches = 0
ssd_prefill.states_launches = ssd_prefill.carry_launches = ssd_prefill.out_launches = 0
ssd_scan_bwd_state.launches = 0
ssd_scan_bwd_state.own_launches = ssd_scan_bwd_state.carry_launches = 0
ssd_scan_bwd_chunk.launches = 0
