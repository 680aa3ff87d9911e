"""EN-T w8a8 serving quantization (port of ``repro/quant/quantize.py``).

``quantize_params`` walks a float param tree and replaces every matmul
kernel (minus skip patterns) with a record bit-equal to the reference's:

    {"q": int8 [I, O], "scale": f32 [1, O],          # per-out-channel
     "planes_packed": int8 [2, I, O]}                # packed EN-T planes

``qdense_apply`` feeds the float activations straight into the fused
packed matmul, which quantizes each row inside the kernel.  Legacy
4-plane ``planes`` records and plane-less ``q`` records need the
``ent_matmul`` and ``int8_matmul`` kernels, which this slice has not
ported; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import re

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.multiplier import ent_packed_planes
from repro_torch.kernels.ent_matmul import ops as ent_ops

__all__ = ["quantize_weight", "quantize_params", "qdense_apply"]


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


def qdense_apply(rec, x, out_dtype=torch.bfloat16, use_kernel: bool = True):
    """Quantized matmul: x [..., K] float x rec -> [..., O]."""
    if "planes_packed" not in rec:
        raise NotImplementedError(
            "only packed-plane records are served in this slice: legacy "
            "4-plane 'planes' records need the ent_matmul kernel and "
            "plane-less 'q' records the int8_matmul kernel (ROADMAP, "
            "kernels still to port)")
    lead = x.shape[:-1]
    y = ent_ops.ent_quantized_matmul_fused(
        x.reshape(-1, x.shape[-1]), rec["planes_packed"], rec["scale"],
        out_dtype=torch.float32, use_kernel=use_kernel)
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
