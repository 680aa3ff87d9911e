"""The benchmark's frozen arithmetic: the H100's peaks, the least time of
an operation, the logical work of the kernels and layers the cells time,
the parameter count behind ``mfu.train``, and the statistics of the
end-to-end metrics.

Later changes to the program may not move any of this, so it is copied
here and not imported from the program:

* the peaks: ``repro_torch/core/roofline.py`` (``PEAKS``, ``HBM_BW``);
* ``model_flops`` and the parameter count: ``core/roofline.py`` and
  ``configs/base.py`` (``ModelConfig._layer_params``), restated over the
  configuration's JSON;
* the SSD scan's counts: ``kernels/ssd_scan/ops.py`` (``_scan_cost``,
  ``_scan_bwd_cost``), restated as the chunked algorithm's logical
  float32 operations (not three split-bf16 passes) at the bf16 peak, the
  fastest any method of that math reaches on this chip;
* kernel 1's count: ``kernels/cost.py`` (``plane_matmul``), restated as
  one logical w8a8 product, 2 M K N at the int8 peak (not one product per
  digit plane), with each int8 weight counted as one byte.
"""

from __future__ import annotations

import math

# one H100 SXM, dense rates (NVIDIA's data sheet; core/roofline.py)
PEAK_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_INT8 = 1979e12         # OP/s, tensor cores
HBM_BW = 3.35e12            # bytes/s
PEAKS = {"bf16": PEAK_BF16, "int8": PEAK_INT8}

SSD_CHUNK = 128             # the chunked scan's chunk, as the kernels define it


def least_s(ops: dict, nbytes: float) -> float:
    """The least time of work ``ops`` ({"bf16" | "int8": operations}) that
    moves ``nbytes`` through HBM: the larger of its compute and memory
    bounds."""
    compute = sum(v / PEAKS[k] for k, v in ops.items())
    return max(compute, nbytes / HBM_BW)


# --- kernel 1 (w8a8 matmul) ----------------------------------------------------

def w8a8_matmul(m: int, k: int, n: int, x_bytes: int = 2, out_bytes: int = 4):
    """One logical w8a8 product X [M, K] x W [K, N]: ({"int8": 2 M K N},
    bytes of X, the int8 weight, the row and column scales and the
    output)."""
    return ({"int8": 2 * m * k * n},
            m * k * x_bytes + k * n + 4 * (m + n) + m * n * out_bytes)


def dense_projections(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of every quantized projection of one attention + SwiGLU layer."""
    d, hd = cfg["d_model"], head_dim(cfg)
    h, hkv, f = cfg["num_heads"], cfg["num_kv_heads"], cfg["d_ff"]
    return [(d, h * hd), (d, hkv * hd), (d, hkv * hd), (h * hd, d),
            (d, f), (d, f), (f, d)]


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def padded_vocab(cfg: dict) -> int:
    return math.ceil(cfg["vocab_size"] / 256) * 256


# --- one serving call of a dense model ------------------------------------------

def attention_pairs(rows: int, pos0: int) -> int:
    """(query, key) pairs a causal chunk of ``rows`` queries at positions
    ``pos0 ..`` keeps over its context and itself."""
    return rows * pos0 + rows * (rows + 1) // 2


def serve_call_least_s(cfg: dict, rows: int, pairs: int, kv_rows: int,
                       head_rows: int) -> float:
    """Least time of one forward call of a dense w8a8 model: ``rows`` token
    rows through every layer's projections (the int8 peak; each weight one
    byte), ``pairs`` kept (query, key) pairs a layer at the bf16 peak (QK
    and PV, 4 hd FLOPs a pair and query head), ``kv_rows`` cached rows a
    layer read (bf16 K and V), and ``head_rows`` rows through the LM head
    (bf16 operands, its bf16 table read once)."""
    layers = cfg["num_layers"]
    hd, h, hkv, d = head_dim(cfg), cfg["num_heads"], cfg["num_kv_heads"], cfg["d_model"]
    proj = sum(k * n for k, n in dense_projections(cfg))
    vocab = padded_vocab(cfg)
    ops = {"int8": layers * 2 * rows * proj,
           "bf16": layers * 4 * pairs * hd * h + 2 * head_rows * d * vocab}
    nbytes = (layers * (proj + 2 * rows * d * 2 + 2 * kv_rows * hkv * hd * 2)
              + vocab * d * 2)
    return least_s(ops, nbytes)


# --- the SSD scan (kernels 8, 8b, 8c) -------------------------------------------

def ssd_fwd_bwd(bsz: int, length: int, heads: int, p: int, n: int, groups: int = 1,
                chunk: int = SSD_CHUNK):
    """The chunked scan's forward and backward at one call's shapes:
    ({"bf16": logical f32 operations}, bytes read and written), from
    kernels/ssd_scan/ops.py's counts without the split-bf16 passes."""
    q = min(chunk, length)
    nc = -(-length // q)
    pairs = q * (q + 1) // 2
    xb, dtb = bsz * length * heads * p, bsz * length * heads
    bcb, st = bsz * length * groups * n, bsz * heads * nc * p * n
    fwd = bsz * heads * nc * (2 * pairs * (n + p) + 4 * q * p * n)
    bwd_state = bsz * heads * (nc - 1) * 2 * q * p * n
    bwd_chunk = bsz * heads * nc * (2 * pairs * (2 * p + 3 * n) + 6 * q * p * n)
    nbytes = 4 * ((2 * xb + dtb + heads + 2 * bcb + st)
                  + (dtb + heads + bcb + xb + st)
                  + (3 * xb + 2 * dtb + 2 * heads + 4 * bcb + 2 * st))
    return {"bf16": fwd + bwd_state + bwd_chunk}, nbytes


# --- the planner's MFU numerator --------------------------------------------------

def ssm_dims(cfg: dict):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    nheads = d_inner // s["head_dim"]
    return d_inner, nheads, d_inner + 2 * s["ngroups"] * s["state_dim"]


def param_count(cfg: dict) -> int:
    """Parameters of an attention-free SSM model or a dense attention
    model as configs/base.py counts them (its SSM layer leaves out the
    conv bias): the planner's N."""
    d = cfg["d_model"]
    n = padded_vocab(cfg) * d * (1 if cfg.get("tie_embeddings") else 2) + d
    if cfg.get("ssm") and not cfg.get("num_heads"):
        s = cfg["ssm"]
        d_inner, nheads, conv_dim = ssm_dims(cfg)
        layer = (d * (2 * d_inner + 2 * s["ngroups"] * s["state_dim"] + nheads)
                 + conv_dim * s.get("conv_width", 4) + 3 * nheads
                 + d_inner * d + d + d_inner)
    else:
        hd, h, hkv = head_dim(cfg), cfg["num_heads"], cfg["num_kv_heads"]
        layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + d
        if cfg.get("qkv_bias"):
            layer += (h + 2 * hkv) * hd
        layer += 3 * d * cfg["d_ff"] + d
    return n + cfg["num_layers"] * layer


def train_flops(cfg: dict, tokens: int) -> float:
    """6 N D (core/roofline.py's ``model_flops`` for a training shape)."""
    return 6 * param_count(cfg) * tokens


# --- statistics -------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of all ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]
