"""BENCHMARK.json against the benchmark's contract, every piece found by
name, and the import rules: nothing of JAX or the JAX package, and a
reference that imports nothing of the program."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import cell as cells
from port_bench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"][:2] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[kind]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    metric_names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            base = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == base, m
            assert NAME.match(m["name"]) and m["name"] not in metric_names
            metric_names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        cell = cells.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names and m["moves"] in e2e
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_piece_is_found_by_name():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("port_bench/")
        cfg = json.loads(path.read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "port_bench" / "reference" / f"{cfg['reference']}.py").is_file()
        assert (ROOT / "port_bench" / f"{cfg['driver']}.py").is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = cells.load(w["name"])
        drv = cells.driver(cell)
        assert all(callable(getattr(drv, f)) for f in ("Run", "check", "passes", "control"))
        kind = ROOT / "port_bench" / "traffic" / f"{cell.traffic['generator']}.py"
        assert kind.is_file(), kind
        assert (ROOT / "port_bench" / "checks" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "port_bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_forbidden_names_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1, "reprolib": 1,
            "numpy": 1}
    assert forbidden_modules(mods) == []
    assert forbidden_modules({**mods, "repro.kernels": 1, "jax": 1, "flax.linen": 1}) == \
        ["flax.linen", "jax", "repro.kernels"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for p in (ROOT / "port_bench").rglob("*.py"):
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p


@pytest.mark.parametrize("module", ["port_bench.reference.dense_lm",
                                    "port_bench.reference.mamba2_lm"])
def test_the_reference_imports_nothing_of_the_program(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert "repro_torch" not in _imports(path)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]; import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True, env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    tops = set(ast.literal_eval(loaded.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload",
                        "qwen-ent.longdoc", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""
