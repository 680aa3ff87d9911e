"""SoC-level NPU model for the paper's benchmark (§4.4, Figs 8-12).

Composition follows Fig 8 / Table 2 exactly: a 256 KB Global Buffer, 64 KB
Activation + 64 KB Weight buffers, a TCU (one 32x32 planar array or two
8^3 cubes, 1024 GOPS @ 500 MHz INT8), a SIMD vector engine (32 TF32 ALUs)
for quantization/pooling/activation, a controller with img2col, and — in
EN-T variants — a bank of 32 encoders on the weight-buffer readout.

The energy model walks a CNN layer table (repro_torch.core.networks), maps each
layer as an im2col GEMM onto the array with 32x32 output tiling, and
integrates component power over the phases in which each component is
active.  Reproduces: Fig 9 (compute engines are 80-94% of on-chip
energy), Figs 10-11 (SoC energy reduction bands per TCU arch), Fig 12
(SoC-level area efficiency).

The port's copy of ``repro/core/soc.py`` (the port imports
nothing of the JAX package): the same constants, functions and names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import hwmodel, networks

FREQ_HZ = 500e6
ARRAY_SIZE = 32           # planar TCUs: 32x32 = 1024 GOPS
CUBE_SIDE = 8             # cube TCU: two 8^3 arrays = 1024 GOPS
NUM_CUBES = 2

# --- Table 2 constants -------------------------------------------------------
GB_AREA = 614400.0        # 256 KB Global Buffer, um^2
GB_READ_W = 0.0205        # W while streaming reads
GB_WRITE_W = 0.04515
AWBUF_AREA = 153600.0     # 64 KB Activation / Weight buffer (x2 instances)
AWBUF_READ_W = 0.0146
AWBUF_WRITE_W = 0.0322
SIMD_AREA = 126481.0      # 32 TF32 ALUs
SIMD_W = 0.0951
CTRL_AREA = 83679.0       # controller + img2col (number: 2)
CTRL_W = 0.0632
ENCODER_BANK_AREA = 1895.36   # 32 encoders, register output
ENCODER_BANK_W = 0.00089

SRAM_PORT_BYTES = 32      # bytes per access cycle at 500 MHz

# Pipeline fill/drain cycles per output tile, per fabric.
_TILE_OVERHEAD = {
    "2d_matrix": 1,
    "1d2d_array": 1,
    "systolic_os": 2 * ARRAY_SIZE,
    "systolic_ws": 2 * ARRAY_SIZE,
    "cube_3d": 2 * CUBE_SIDE,
}


@dataclass(frozen=True)
class SoCConfig:
    tcu_arch: str                 # one of hwmodel.ARCHS
    variant: str = "baseline"     # baseline | ent_mbe | ent_ours

    def tcu_configs(self):
        if self.tcu_arch == "cube_3d":
            return [hwmodel.TCUConfig("cube_3d", CUBE_SIDE, self.variant)] * NUM_CUBES
        return [hwmodel.TCUConfig(self.tcu_arch, ARRAY_SIZE, self.variant)]

    @property
    def tcu_power_w(self) -> float:
        return sum(hwmodel.power_uw(c) for c in self.tcu_configs()) / 1e6

    @property
    def tcu_area_um2(self) -> float:
        return sum(hwmodel.area_um2(c) for c in self.tcu_configs())

    @property
    def num_mults(self) -> int:
        return sum(hwmodel.num_multipliers(c) for c in self.tcu_configs())

    @property
    def soc_area_um2(self) -> float:
        area = (self.tcu_area_um2 + GB_AREA + 2 * AWBUF_AREA + SIMD_AREA
                + 2 * CTRL_AREA)
        if self.variant != "baseline":
            area += ENCODER_BANK_AREA
        return area


def _gemm_tiles(layer: networks.ConvLayer):
    """(m_tiles, n_tiles, k) of the layer's im2col GEMM on a 32-wide array."""
    return (math.ceil(layer.m / ARRAY_SIZE), math.ceil(layer.n / ARRAY_SIZE), layer.kdim)


@dataclass
class SoCReport:
    energy_j: dict               # component -> joules
    time_s: float
    utilization: float           # MACs / (cycles * mults)

    @property
    def total_j(self) -> float:
        return sum(self.energy_j.values())

    @property
    def compute_engine_fraction(self) -> float:
        """Fig 9 metric: (TCU + SIMD + controller) / total on-chip."""
        e = self.energy_j
        num = e["tcu"] + e["simd"] + e["ctrl"] + e.get("encoders", 0.0)
        return num / self.total_j


def run_inference(network_name: str, cfg: SoCConfig) -> SoCReport:
    """Single-frame inference energy breakdown (the paper's Fig 10 setup)."""
    layers = networks.network(network_name)
    overhead = _TILE_OVERHEAD[cfg.tcu_arch]

    cycles = 0
    macs = 0
    wbuf_read_bytes = 0
    abuf_read_bytes = 0
    awbuf_write_bytes = 0
    gb_read_bytes = 0
    gb_write_bytes = 0
    out_elems = 0
    for lyr in layers:
        mt, nt, k = _gemm_tiles(lyr)
        cycles += mt * nt * (k + overhead)
        macs += lyr.macs
        # weight tiles stream from the weight buffer once per m-tile pass
        wbuf_read_bytes += mt * k * min(lyr.n, ARRAY_SIZE) * nt
        # im2col activations stream once per n-tile pass
        abuf_read_bytes += nt * lyr.m * k
        # buffers are filled from the GB once per unique byte (double
        # buffering hides latency; energy still paid)
        awbuf_write_bytes += lyr.weight_bytes + lyr.im2col_bytes
        gb_read_bytes += lyr.weight_bytes + lyr.im2col_bytes
        gb_write_bytes += lyr.out_bytes
        out_elems += lyr.m * lyr.n

    t_compute = cycles / FREQ_HZ
    t_simd = out_elems / 32 / FREQ_HZ          # 1 post-op per output element
    t_wread = wbuf_read_bytes / SRAM_PORT_BYTES / FREQ_HZ
    t_aread = abuf_read_bytes / SRAM_PORT_BYTES / FREQ_HZ
    t_awwrite = awbuf_write_bytes / SRAM_PORT_BYTES / FREQ_HZ
    t_gbread = gb_read_bytes / SRAM_PORT_BYTES / FREQ_HZ
    t_gbwrite = gb_write_bytes / SRAM_PORT_BYTES / FREQ_HZ

    energy = {
        "tcu": cfg.tcu_power_w * t_compute,
        "simd": SIMD_W * t_simd,
        "ctrl": CTRL_W * t_compute,            # active for the whole run
        "sram_read": AWBUF_READ_W * (t_wread + t_aread) + GB_READ_W * t_gbread,
        "sram_write": AWBUF_WRITE_W * t_awwrite + GB_WRITE_W * t_gbwrite,
    }
    if cfg.variant != "baseline":
        # 32 encoders re-encode weights on the weight-buffer readout path
        energy["encoders"] = ENCODER_BANK_W * t_wread
    util = macs / (cycles * cfg.num_mults)
    return SoCReport(energy, t_compute, util)


def energy_reduction(network_name: str, tcu_arch: str,
                     variant: str = "ent_ours") -> float:
    """Fractional SoC energy reduction of an EN-T variant (Fig 11)."""
    base = run_inference(network_name, SoCConfig(tcu_arch, "baseline"))
    ent = run_inference(network_name, SoCConfig(tcu_arch, variant))
    return 1.0 - ent.total_j / base.total_j


def soc_area_efficiency_gain(tcu_arch: str, variant: str = "ent_ours") -> float:
    """Fig 12: GOPS/mm^2 at SoC level (same GOPS, smaller die)."""
    base = SoCConfig(tcu_arch, "baseline")
    ent = SoCConfig(tcu_arch, variant)
    return base.soc_area_um2 / ent.soc_area_um2 - 1.0
