"""The port's copies of the paper's hardware models (``repro_torch/core/
gates.py``, ``hwmodel.py``, ``networks.py``, ``soc.py``) and tables
(``core/paper_tables.py``, ``core/fit_hwmodel.py``) against the
reference's, with exact float equality (the same Python arithmetic):
every public function over every arch, size and variant, every network
and every row of ``ALL_TABLES``; then ``examples/torch_quickstart.py``,
``examples/torch_train_minicpm.py`` (through its crash and restore) and
``examples/torch_hw_efficiency_report.py`` on the CPU."""

import dataclasses
import importlib.util
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import gates as ref_gates  # noqa: E402
from repro.core import hwmodel as ref_hw  # noqa: E402
from repro.core import networks as ref_net  # noqa: E402
from repro.core import soc as ref_soc  # noqa: E402
from repro_torch.core import fit_hwmodel, gates, networks, paper_tables, soc  # noqa: E402
from repro_torch.core import hwmodel as hw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _constants(mod):
    """Upper-case module names (tables of builder functions left out:
    ``networks._BUILDERS``' functions are held through ``network``)."""
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not (isinstance(v, dict) and any(map(callable, v.values())))}


@pytest.mark.parametrize("port,ref", [(gates, ref_gates), (hw, ref_hw), (networks, ref_net),
                                      (soc, ref_soc)], ids=["gates", "hwmodel", "networks",
                                                            "soc"])
def test_constants_and_names_equal_reference(port, ref):
    assert _constants(port) == _constants(ref)
    public = lambda m: sorted(k for k, v in vars(m).items()   # noqa: E731
                              if not k.startswith("_") and callable(v)
                              and getattr(v, "__module__", "").endswith(m.__name__.split(".")[-1]))
    assert public(port) == public(ref)


def test_gates_equal_reference():
    for n in range(0, 40):
        assert gates.ent_encoder_delay(n) == ref_gates.ent_encoder_delay(n)


HW_FNS = ("num_multipliers", "num_edge_encoder_lanes", "encoders_saved", "gops", "acc_bits",
          "bits_a", "raw_breakdown", "area_um2", "power_uw", "area_efficiency",
          "energy_efficiency")
SIZES = (2, 4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("arch", ref_hw.ARCHS)
def test_hwmodel_equal_reference(arch):
    for size in SIZES:
        for variant in ref_hw.VARIANTS:
            for n_bits in (8, 16):
                p = hw.TCUConfig(arch, size, variant, n_bits=n_bits)
                r = ref_hw.TCUConfig(arch, size, variant, n_bits=n_bits)
                assert dataclasses.astuple(p) == dataclasses.astuple(r)
                for name in HW_FNS:
                    assert getattr(hw, name)(p) == getattr(ref_hw, name)(r), (name, size)
            assert hw.improvement(arch, size, variant) == ref_hw.improvement(arch, size, variant)


def test_scale_averages_and_refusals_equal_reference():
    for scale in ref_hw.SCALE_SIZES:
        for variant in ref_hw.VARIANTS:
            assert hw.scale_average(scale, variant) == ref_hw.scale_average(scale, variant)
    with pytest.raises(ValueError):
        hw.TCUConfig("hexagonal", 32)
    with pytest.raises(ValueError):
        hw.TCUConfig("2d_matrix", 32, "ent_magic")


@pytest.mark.parametrize("name", ref_net.NETWORKS)
def test_networks_equal_reference(name):
    port, ref = networks.network(name), ref_net.network(name)
    props = ("m", "kdim", "n", "macs", "weight_bytes", "out_bytes", "im2col_bytes")
    assert [(dataclasses.astuple(a), *(getattr(a, k) for k in props)) for a in port] == \
        [(dataclasses.astuple(b), *(getattr(b, k) for k in props)) for b in ref]
    assert networks.total_macs(name) == ref_net.total_macs(name)
    assert networks.total_weight_bytes(name) == ref_net.total_weight_bytes(name)


@pytest.mark.parametrize("arch", ref_hw.ARCHS)
def test_soc_equal_reference(arch):
    for variant in ref_hw.VARIANTS:
        p, r = soc.SoCConfig(arch, variant), ref_soc.SoCConfig(arch, variant)
        for k in ("tcu_power_w", "tcu_area_um2", "num_mults", "soc_area_um2"):
            assert getattr(p, k) == getattr(r, k), k
        assert soc.soc_area_efficiency_gain(arch, variant) == \
            ref_soc.soc_area_efficiency_gain(arch, variant)
        for net in ref_net.NETWORKS:
            a, b = soc.run_inference(net, p), ref_soc.run_inference(net, r)
            assert (a.energy_j, a.time_s, a.utilization, a.total_j,
                    a.compute_engine_fraction) == (b.energy_j, b.time_s, b.utilization,
                                                   b.total_j, b.compute_engine_fraction)
            assert soc.energy_reduction(net, arch, variant) == \
                ref_soc.energy_reduction(net, arch, variant)


@pytest.fixture(scope="module")
def ref_tables():
    return _load(ROOT / "benchmarks" / "paper_tables.py", "ref_paper_tables")


def test_paper_tables_equal_reference(ref_tables):
    assert [f.__name__ for f in paper_tables.ALL_TABLES] == \
        [f.__name__ for f in ref_tables.ALL_TABLES]
    for port_fn, ref_fn in zip(paper_tables.ALL_TABLES, ref_tables.ALL_TABLES):
        assert port_fn() == ref_fn(), port_fn.__name__


def test_fit_hwmodel_equal_reference(monkeypatch):
    """The calibration solves the same P&R factors (the fit writes them
    into the tables: both packages' tables are patched copies here)."""
    ref_fit = _load(ROOT / "benchmarks" / "fit_hwmodel.py", "ref_fit_hwmodel")
    for mod in (hw, ref_hw):
        monkeypatch.setattr(mod, "PNR_AREA", dict(mod.PNR_AREA))
        monkeypatch.setattr(mod, "PNR_POWER", dict(mod.PNR_POWER))
    assert fit_hwmodel.TARGET_AREA == ref_fit.TARGET_AREA
    assert fit_hwmodel.TARGET_ENERGY == ref_fit.TARGET_ENERGY
    for arch in ref_hw.ARCHS:
        for metric, targets in (("area_eff", ref_fit.TARGET_AREA),
                                ("energy_eff", ref_fit.TARGET_ENERGY)):
            assert fit_hwmodel.solve(arch, metric, targets[arch]) == \
                ref_fit.solve(arch, metric, targets[arch])
    port_out, ref_out = io.StringIO(), io.StringIO()
    with redirect_stdout(port_out):
        fit_hwmodel.main()
    with redirect_stdout(ref_out):
        ref_fit.main()
    assert port_out.getvalue() == ref_out.getvalue()


# .. the port's examples on the CPU ..

def test_quickstart_example_runs_on_cpu(capsys):
    qs = _load(ROOT / "examples" / "torch_quickstart.py", "torch_quickstart")
    loss = qs.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Encode(78) = [0, 1, 1, -1, 2]" in out
    assert "digit-plane matmul == int32 matmul: bit-exact" in out
    assert "packed-plane matmul (2 planes) == int32 matmul: bit-exact" in out
    assert "1TOPS: area-eff +12.2%" in out
    assert 0 < loss < 20


def test_train_example_crashes_restores_and_resumes_on_cpu(capsys):
    """104 steps: saves at 50 and 100, the crash at 52 restores 50, so
    steps 51 and 52 run twice with equal losses (one thread: the step is
    deterministic)."""
    ex = _load(ROOT / "examples" / "torch_train_minicpm.py", "torch_train_minicpm")
    losses = ex.main(["--steps", "104", "--seq", "16", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "simulating failure at step 52" in out and "done; checkpoints in" in out
    steps = [s for s, _ in losses]
    assert steps == list(range(1, 53)) + list(range(51, 105))
    first = dict(losses[:52])
    again = dict(losses[52:54])
    assert again == {51: first[51], 52: first[52]}


def test_report_example_runs(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["torch_hw_efficiency_report.py"])
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / "torch_hw_efficiency_report.py"),
                       run_name="__main__")
    text = out.getvalue()
    assert text.count("\n### ") == len(paper_tables.ALL_TABLES)
    assert "Table 1 (encoder cost vs width)" in text
