"""Analytic area/power/energy model of tensor compute units (paper §4.3).

Models the five TCU microarchitectures of Fig 2 at the cell level using
the calibrated SMIC 40nm constants in :mod:`repro_torch.core.gates`, in three
variants:

* ``baseline``  — every PE contains a full DW multiplier (encoder inside);
* ``ent_mbe``   — EN-T array topology with MBE encoders hoisted to the
                  edge (encoded width 12 for INT8 -> wider pipelined buses);
* ``ent_ours``  — EN-T with the paper's carry-chain encoder (width 9).

Composition per microarchitecture (per multiplier unless noted):

  2d_matrix    mult + B reg + row adder tree (shared) + out acc
               (A is broadcast combinationally -> MBE widening costs
               wiring only, per paper §4.3)
  1d2d_array   bare mult + adder tree (shared) + out acc ("no PEs") with
               carry-save fusion of the EN-T multiplier into the tree
  systolic_os  mult + A/B pipeline regs + per-PE accumulator (FA + reg)
               (A flows through registers -> widening costs regs)
  systolic_ws  mult + A/weight regs + psum adder + psum reg
  cube_3d      mult + A/B regs + per-dot-unit adder tree + out acc;
               c^2 encoder lanes per c^3 multipliers (paper §4.4)

**Reproduction finding** (EXPERIMENTS.md §Paper-validation): the paper's
own Table 1 cell deltas (27.2 um^2 / 22.5 uW per multiplier) cannot by
themselves produce its reported TCU-level gains (e.g. 17.5% average
energy-efficiency at 1 TOPS) under any standard PE composition — the
cell-level model tops out at ~4-16% depending on fabric.  The remainder
must come from place&route-level effects (compaction -> shorter nets,
relaxed congestion, smaller clock tree) that the paper itself invokes
("the reduced array area makes data transmission pathways shorter").  We
model those as per-architecture P&R amplification factors on the EN-T
delta, ramping linearly with array size up to the reference scale
(1 TOPS), calibrated once against Fig 7 + the SoC bands; the SoC
benchmark (Figs 9-12) validates the calibrated model out-of-sample.

The port's copy of ``repro/core/hwmodel.py`` (the port imports
nothing of the JAX package): the same constants, functions and names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.core import gates

ARCHS = ("2d_matrix", "1d2d_array", "systolic_os", "systolic_ws", "cube_3d")
VARIANTS = ("baseline", "ent_mbe", "ent_ours")

# Array sizes used by the paper per compute scale (500 MHz, INT8, 2 ops/MAC):
# 16^2 = 256 GOPS, 32^2 = 1 TOPS, 64^2 = 4 TOPS; cube sides 4/8/16.
SCALE_SIZES = {"256GOPS": 16, "1TOPS": 32, "4TOPS": 64}
CUBE_SIZES = {"256GOPS": 4, "1TOPS": 8, "4TOPS": 16}
_REF_SIZE = {"2d_matrix": 32, "1d2d_array": 32, "systolic_os": 32,
             "systolic_ws": 32, "cube_3d": 8}

# P&R amplification of the EN-T delta (see module docstring; calibrated by
# repro_torch/core/fit_hwmodel.py; values frozen after the fit).
PNR_AREA = {
    "2d_matrix": 3.31,
    "1d2d_array": 1.22,
    "systolic_os": 4.36,
    "systolic_ws": 4.16,
    "cube_3d": 6.95,
}
PNR_POWER = {
    "2d_matrix": 3.43,
    "1d2d_array": 1.21,
    "systolic_os": 4.17,
    "systolic_ws": 3.96,
    "cube_3d": 2.79,
}
# P&R effects ramp with array size (compaction matters more on big arrays),
# saturating at the reference (1 TOPS) scale: eff = 1 + (P-1)*min(S/ref, 1).
PNR_SCALE_EXP = 0.8


@dataclass(frozen=True)
class TCUConfig:
    arch: str
    size: int                  # S for planar fabrics, cube side c for cube_3d
    variant: str = "baseline"
    n_bits: int = 8
    freq_hz: float = 500e6

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")


def num_multipliers(cfg: TCUConfig) -> int:
    return cfg.size**3 if cfg.arch == "cube_3d" else cfg.size**2


def num_edge_encoder_lanes(cfg: TCUConfig) -> int:
    """Encoder lanes at the array edge (one per multiplicand stream).

    Planar: one lane per row = S.  Cube: one per dot unit on the input
    face = c^2 (paper §4.4: two 8^3 cubes need 128 = 2 x 8^2 encoders).
    """
    if cfg.variant == "baseline":
        return 0
    return cfg.size**2 if cfg.arch == "cube_3d" else cfg.size


def encoders_saved(cfg: TCUConfig) -> int:
    """Encoders removed vs baseline (paper §4.4: 32x32 planar saves 992;
    two 8^3 cubes save 896)."""
    return num_multipliers(cfg) - num_edge_encoder_lanes(cfg)


def gops(cfg: TCUConfig) -> float:
    return 2 * num_multipliers(cfg) * cfg.freq_hz / 1e9


def acc_bits(cfg: TCUConfig) -> int:
    """Accumulator width 16 + log2(S) (paper §4.3)."""
    return 16 + int(math.ceil(math.log2(cfg.size)))


def bits_a(cfg: TCUConfig) -> int:
    """Width of the multiplicand path through the array."""
    if cfg.variant == "baseline":
        return cfg.n_bits
    if cfg.variant == "ent_mbe":
        return -(-cfg.n_bits // 2) * 3   # ceil(n/2) digits x 3 control bits
    return cfg.n_bits + 1                # ent_ours: n+1 (paper §3.3)


def _mult_cost(cfg: TCUConfig):
    """(area, power) of the in-array multiplier for this variant."""
    if cfg.variant == "baseline":
        a, p = gates.MULT_AREA["dw_ip"], gates.MULT_POWER["dw_ip"]
    elif cfg.variant == "ent_mbe":
        a, p = gates.MBE_MULT_RME_AREA, gates.MBE_MULT_RME_POWER
    else:
        a, p = gates.MULT_AREA["rme_ours"], gates.MULT_POWER["rme_ours"]
    if cfg.variant == "ent_ours" and cfg.arch == "1d2d_array":
        # carry-save fusion into the adder tree — only possible where the
        # multiplier output feeds a tree with no pipeline boundary
        a -= gates.TREE_FUSION_AREA_SAVE
        p -= gates.TREE_FUSION_POWER_SAVE
    return a, p


def _per_mult_reg_bits(cfg: TCUConfig) -> float:
    """Pipeline/operand register bits per multiplier."""
    ab, b, w = bits_a(cfg), cfg.n_bits, acc_bits(cfg)
    return {
        "2d_matrix": b,              # B registered; A broadcast (no reg)
        "1d2d_array": 0,             # "no PEs" — fully combinational
        "systolic_os": ab + b,       # A and B flow through registers
        "systolic_ws": ab + b + w,   # A flows, weight reg, psum reg
        "cube_3d": ab + b,           # A and B flow along cube faces
    }[cfg.arch]


def _per_mult_acc_fa_bits(cfg: TCUConfig):
    """(full-adder bits, register bits) of accumulation logic per mult."""
    w, s = acc_bits(cfg), cfg.size
    if cfg.arch in ("2d_matrix", "1d2d_array", "cube_3d"):
        # adder tree: (fanin-1) CSAs of width w shared by fanin mults
        return w * (s - 1) / s, w / s
    if cfg.arch == "systolic_os":
        return w, w                  # per-PE accumulator (FA + reg)
    return w, 0.0                    # WS: psum adder (reg counted above)


def _edge_encoder_cost(cfg: TCUConfig):
    """(area, power) of the hoisted encoder bank incl. output registers."""
    lanes = num_edge_encoder_lanes(cfg)
    if lanes == 0:
        return 0.0, 0.0
    if cfg.variant == "ent_mbe":
        n_enc, ea, ep = 4, gates.MBE_ENCODER_AREA, gates.MBE_ENCODER_POWER
    else:
        n_enc, ea, ep = 3, gates.ENT_ENCODER_AREA, gates.ENT_ENCODER_POWER
    out_bits = bits_a(cfg)
    area = lanes * (n_enc * ea + out_bits * gates.REG_BIT_AREA)
    power = lanes * (n_enc * ep + out_bits * gates.REG_BIT_POWER)
    return area, power


def raw_breakdown(cfg: TCUConfig):
    """(area, power) breakdown dicts at cell level + wiring, pre-P&R."""
    n = num_multipliers(cfg)
    ma, mp = _mult_cost(cfg)
    rb = _per_mult_reg_bits(cfg)
    fa, ar = _per_mult_acc_fa_bits(cfg)
    ea, ep = _edge_encoder_cost(cfg)
    area = {
        "mult": n * ma,
        "regs": n * rb * gates.REG_BIT_AREA,
        "acc": n * (fa * gates.FA_BIT_AREA + ar * gates.REG_BIT_AREA),
        "encoders": ea,
    }
    power = {
        "mult": n * mp,
        "regs": n * rb * gates.REG_BIT_POWER,
        "acc": n * (fa * gates.FA_BIT_POWER + ar * gates.REG_BIT_POWER),
        "encoders": ep,
    }
    # Interconnect: A-distribution bus bits x PE pitch x congestion(S).
    pitch = math.sqrt(sum(area.values()) / n)
    cong = (cfg.size / _REF_SIZE[cfg.arch]) ** gates.WIRE_CONGESTION_EXP
    area["wiring"] = gates.WIRE_AREA_COEFF[cfg.arch] * n * bits_a(cfg) * pitch * cong
    power["wiring"] = gates.WIRE_POWER_COEFF[cfg.arch] * n * bits_a(cfg) * pitch * cong
    return area, power


def _pnr_eff(table, cfg: TCUConfig) -> float:
    ramp = min(cfg.size / _REF_SIZE[cfg.arch], 1.0) ** PNR_SCALE_EXP
    return 1.0 + (table[cfg.arch] - 1.0) * ramp


def _total(cfg: TCUConfig, which: int, table) -> float:
    raw = raw_breakdown(cfg)[which]
    total = sum(raw.values())
    if cfg.variant == "baseline":
        return total
    base = sum(raw_breakdown(replace(cfg, variant="baseline"))[which].values())
    delta = base - total
    if delta <= 0:
        # a widened/penalized variant gets no P&R compaction credit
        return total
    return base - delta * _pnr_eff(table, cfg)


def area_um2(cfg: TCUConfig) -> float:
    return _total(cfg, 0, PNR_AREA)


def power_uw(cfg: TCUConfig) -> float:
    return _total(cfg, 1, PNR_POWER)


def area_efficiency(cfg: TCUConfig) -> float:
    """GOPS per mm^2."""
    return gops(cfg) / (area_um2(cfg) / 1e6)


def energy_efficiency(cfg: TCUConfig) -> float:
    """TOPS per W."""
    return (gops(cfg) / 1e3) / (power_uw(cfg) / 1e6)


def improvement(arch: str, size: int, variant: str = "ent_ours") -> dict:
    """Fractional efficiency improvements of an EN-T variant vs baseline."""
    base = TCUConfig(arch, size, "baseline")
    ent = TCUConfig(arch, size, variant)
    return {
        "area_eff": area_efficiency(ent) / area_efficiency(base) - 1.0,
        "energy_eff": energy_efficiency(ent) / energy_efficiency(base) - 1.0,
        "encoders_saved": encoders_saved(ent),
    }


def scale_average(scale: str, variant: str = "ent_ours") -> dict:
    """Average improvement across the five microarchitectures at a scale
    bucket (the paper's Fig 7 headline numbers)."""
    accs = {"area_eff": 0.0, "energy_eff": 0.0}
    for arch in ARCHS:
        size = CUBE_SIZES[scale] if arch == "cube_3d" else SCALE_SIZES[scale]
        imp = improvement(arch, size, variant)
        for k in accs:
            accs[k] += imp[k]
    return {k: v / len(ARCHS) for k, v in accs.items()}
