"""EN-T w8a8 serving quantization (port of ``repro/quant/quantize.py``).

``quantize_params`` walks a float param tree and replaces every matmul
kernel (minus skip patterns) with a record bit-equal to the reference's:

    {"q": int8 [I, O], "scale": f32 [1, O],          # per-out-channel
     "planes_packed": int8 [2, I, O]}                # packed EN-T planes

With ``QuantConfig(ent_encode=False)`` the record keeps no planes (the
plain w8a8 int8 form).  ``qdense_apply`` serves all three record kinds,
as the reference does: packed records feed the float activations
straight into the fused packed matmul, which quantizes each row inside
the kernel; legacy 4-plane ``planes`` records (``ent_ops.encode_weights``,
old checkpoints) and plane-less ``q`` records quantize the activations
first (``quantize_acts``) and run the 4-plane ``ent_matmul`` or the
``int8_matmul`` kernel.
"""

from __future__ import annotations

import re

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.multiplier import ent_packed_planes
from repro_torch.kernels.ent_matmul import ops as ent_ops
from repro_torch.kernels.ent_matmul.ref import quantize_rows
from repro_torch.kernels.int8_matmul import ops as int8_ops

__all__ = ["quantize_weight", "quantize_params", "quantize_acts",
           "qdense_apply", "dequantize_weight"]


def quantize_weight(w, *, ent_encode: bool = True, per_channel: bool = True):
    """Symmetric int8 quantization of a [..., I, O] kernel (+ packed
    EN-T planes [..., 2, I, O], the reference's vmapped layout)."""
    w32 = w.to(torch.float32)
    if per_channel:
        amax = w32.abs().amax(dim=-2, keepdim=True)             # [..., 1, O]
    else:
        amax = w32.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    rec = {"q": q, "scale": scale}
    if ent_encode:
        rec["planes_packed"] = ent_packed_planes(q).movedim(0, -3).contiguous()
    return rec


def dequantize_weight(rec):
    return rec["q"].to(torch.float32) * rec["scale"]


def quantize_acts(x):
    """Dynamic symmetric per-row int8 activation quantization: x [..., K]
    float -> (q int8, scale f32 [..., 1]), the reference's ``x / scale``
    with round half to even (the same function as ``quantize_rows``)."""
    return quantize_rows(x)


def qdense_apply(rec, x, out_dtype=torch.bfloat16, use_kernel: bool = True):
    """Quantized matmul: x [..., K] float x rec -> [..., O]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "planes_packed" in rec:
        # fused path: per-row act-quant happens inside the packed kernel
        y = ent_ops.ent_quantized_matmul_fused(
            x2, rec["planes_packed"], rec["scale"], out_dtype=torch.float32,
            use_kernel=use_kernel)
    elif "planes" in rec:   # legacy 4-plane records
        xq, sx = quantize_acts(x2)
        y = ent_ops.ent_quantized_matmul(
            xq, rec["planes"], sx, rec["scale"], out_dtype=torch.float32,
            use_kernel=use_kernel)
    else:
        xq, sx = quantize_acts(x2)
        y = int8_ops.quantized_matmul(
            xq, rec["q"], sx, rec["scale"], out_dtype=torch.float32,
            use_kernel=use_kernel)
    y = y.to(out_dtype).reshape(*lead, -1)
    if "bias" in rec:
        y = y + rec["bias"].to(out_dtype)
    return y


def _should_skip(path: str, qcfg: QuantConfig) -> bool:
    return any(re.search(p, path) for p in qcfg.skip_patterns)


def quantize_params(params, qcfg: QuantConfig, path: str = ""):
    """Quantize every >=2D ``{"kernel": w[, "bias": b]}`` record whose
    path matches no skip pattern; everything else passes through.
    ``path`` is the tree position of ``params`` (for quantizing one
    layer at a time, e.g. ``"/layers/3"``)."""
    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and not _should_skip(path, qcfg):
                kern = node["kernel"]
                if kern.dim() >= 2:
                    rec = quantize_weight(kern, ent_encode=qcfg.ent_encode,
                                          per_channel=qcfg.per_channel)
                    if "bias" in node:
                        rec["bias"] = node["bias"]
                    return rec
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}") for i, v in enumerate(node))
        return node

    return walk(params, path)
