"""Reproductions of every EN-T paper table/figure, one function each.

Each function returns (rows, paper_reference) where rows are dicts ready
for CSV/markdown; examples/torch_hw_efficiency_report.py prints them.
Model-vs-paper deltas are printed wherever the paper discloses a number.

The port's copy of ``benchmarks/paper_tables.py`` (the port imports
nothing of the JAX package): the same constants, functions and names.
"""

from __future__ import annotations

from repro_torch.core import gates, hwmodel as hw, networks, soc
from repro_torch.core.encoding import (ent_encoded_bits, ent_num_encoders,
                                 mbe_encoded_bits, mbe_num_encoders)

# Table 1 (upper/mid): encoder comparison across widths --------------------

_PAPER_T1 = {  # width -> (mbe_area, ours_area, mbe_power, ours_power, ours_delay)
    8: (28.22, 25.93, 24.06, 21.47, 0.36),
    10: (35.28, 34.57, 30.07, 28.47, 0.45),
    12: (42.34, 42.22, 36.03, 35.49, 0.54),
    14: (49.39, 50.86, 42.03, 42.45, 0.63),
    16: (56.45, 60.51, 48.05, 49.40, 0.71),
    18: (63.50, 69.15, 54.01, 56.36, 0.80),
    20: (70.56, 77.79, 60.00, 63.31, 0.89),
    24: (84.67, 95.08, 71.96, 77.23, 1.07),
    32: (112.90, 129.65, 95.89, 105.14, 1.41),
}


def table1_encoders():
    rows = []
    for width, paper in sorted(_PAPER_T1.items()):
        n_mbe, n_ours = mbe_num_encoders(width), ent_num_encoders(width)
        model_mbe_area = n_mbe * gates.MBE_ENCODER_AREA
        model_ours_area = n_ours * gates.ENT_ENCODER_AREA
        rows.append({
            "width": width,
            "mbe_encoders": n_mbe,
            "ours_encoders": n_ours,
            "mbe_bits": mbe_encoded_bits(width),
            "ours_bits": ent_encoded_bits(width),
            "mbe_area_model": round(model_mbe_area, 2),
            "mbe_area_paper": paper[0],
            "ours_area_model": round(model_ours_area, 2),
            "ours_area_paper": paper[1],
            "ours_delay_model": round(gates.ent_encoder_delay(n_ours), 2),
            "ours_delay_paper": paper[4],
        })
    return rows, "Table 1 (encoder cost vs width)"


def table1_multipliers():
    rows = []
    for name, label in [("dw_ip", "DW IP"), ("mbe", "MBE"),
                        ("ours", "Ours"), ("rme_ours", "RME_Ours")]:
        rows.append({
            "multiplier": label,
            "area_um2": gates.MULT_AREA[name],
            "delay_ns": gates.MULT_DELAY[name],
            "power_uw": gates.MULT_POWER[name],
        })
    return rows, "Table 1 (INT8 multiplier comparison, paper constants)"


# Fig 6: TCU area / power ---------------------------------------------------

def fig6_area_power():
    rows = []
    for arch in hw.ARCHS:
        for scale in ("256GOPS", "1TOPS", "4TOPS"):
            size = (hw.CUBE_SIZES if arch == "cube_3d" else hw.SCALE_SIZES)[scale]
            for variant in hw.VARIANTS:
                cfg = hw.TCUConfig(arch, size, variant)
                rows.append({
                    "arch": arch, "scale": scale, "variant": variant,
                    "area_mm2": round(hw.area_um2(cfg) / 1e6, 4),
                    "power_mw": round(hw.power_uw(cfg) / 1e3, 2),
                    "encoders_saved": hw.encoders_saved(cfg),
                })
    return rows, "Fig 6 (TCU area & power, 5 fabrics x 3 scales x 3 variants)"


# Fig 7: efficiency up-ratios ------------------------------------------------

_PAPER_FIG7 = {"256GOPS": (0.087, 0.130), "1TOPS": (0.122, 0.175),
               "4TOPS": (0.110, 0.155)}


def fig7_efficiency():
    rows = []
    for scale, (pa, pe) in _PAPER_FIG7.items():
        avg = hw.scale_average(scale)
        rows.append({
            "scale": scale,
            "area_eff_gain_model": round(avg["area_eff"], 4),
            "area_eff_gain_paper": pa,
            "energy_eff_gain_model": round(avg["energy_eff"], 4),
            "energy_eff_gain_paper": pe,
        })
    imp = hw.improvement("1d2d_array", 32)
    rows.append({
        "scale": "1TOPS:1d2d_array",
        "area_eff_gain_model": round(imp["area_eff"], 4),
        "area_eff_gain_paper": 0.202,
        "energy_eff_gain_model": round(imp["energy_eff"], 4),
        "energy_eff_gain_paper": 0.205,
    })
    return rows, "Fig 7 (avg efficiency gains; paper headline numbers)"


# Figs 9-12: SoC benchmark ----------------------------------------------------

_PAPER_FIG11 = {
    "2d_matrix": (15.1, 15.9), "systolic_os": (11.3, 12.8),
    "systolic_ws": (10.2, 11.7), "1d2d_array": (14.0, 16.0),
    "cube_3d": (5.0, 6.0),
}


def fig9_energy_fractions():
    rows = []
    for net in networks.NETWORKS:
        r = soc.run_inference(net, soc.SoCConfig("systolic_os", "baseline"))
        rows.append({
            "network": net,
            "compute_engine_fraction": round(r.compute_engine_fraction, 4),
            "utilization": round(r.utilization, 4),
            "total_mj": round(r.total_j * 1e3, 3),
        })
    return rows, "Fig 9 (SoC energy fraction of compute engines; paper: 80-94%)"


def fig10_11_soc_reduction():
    rows = []
    for arch, (lo, hi) in _PAPER_FIG11.items():
        reds = [soc.energy_reduction(n, arch) * 100 for n in networks.NETWORKS]
        rows.append({
            "tcu_arch": arch,
            "reduction_min_model": round(min(reds), 2),
            "reduction_max_model": round(max(reds), 2),
            "paper_band": f"{lo}-{hi}",
        })
    return rows, "Figs 10-11 (SoC energy reduction per TCU arch)"


def fig12_soc_area():
    rows = []
    for arch in hw.ARCHS:
        rows.append({
            "tcu_arch": arch,
            "soc_area_eff_gain": round(soc.soc_area_efficiency_gain(arch), 4),
        })
    return rows, "Fig 12 (SoC-level area-efficiency gain)"


ALL_TABLES = [table1_encoders, table1_multipliers, fig6_area_power,
              fig7_efficiency, fig9_energy_fractions, fig10_11_soc_reduction,
              fig12_soc_area]
