"""The port's dry-run planner (``launch/dryrun.py``) against the
reference's compiled dry-run, and its report.

(a) Per-rank argument bytes: the reference compiles ``_compile_once``
for reduced qwen2.5-3b, mamba2-370m and mixtral-8x7b at train_4k,
prefill_32k and decode_32k on a (2, 4) mesh of 8 host devices (a fresh
process; ``Auto`` axes: the dry-run's default ``Explicit`` axes refuse
its sharding constraints under this jax) and reads XLA's
``argument_size_in_bytes``; the port's ``argument_gb`` x 1e9 on a (2, 4)
``AbstractMesh`` equals it exactly.  A decode cell differs only by the
leaf one cache layout holds and the other does not: the reference's
int32 ``pos`` scalar, 4 bytes.  (b) Full width: jamba-1.5-large
decode_32k and qwen2.5-3b train_4k on the production mesh give ``ok``
records with the reference's key set (``lower_s`` / ``compile_s`` as
``trace_s``; XLA:CPU's two inflation keys dropped, ``fits_80gb`` added),
and the process's resident memory grows by far less than the 4.78 TB of
jamba's training state.  (c) ``roofline_report`` renders its three
tables from the records.
"""

import json
import os
import resource
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_ref_proc as ref_proc  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import dryrun, roofline_report  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402

ARCHS = ("qwen2.5-3b", "mamba2-370m", "mixtral-8x7b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
# the leaves only the reference's decode cache holds, with their bytes
REF_ONLY_DECODE = {"pos": 4}

_REF_SCRIPT = """
import json
import jax
from jax.sharding import AxisType
assert len(jax.devices()) == 8
from repro.configs import reduced_config
from repro.launch import dryrun   # sets XLA_FLAGS: too late, the backend is up
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in %r:
    for shape in %r:
        compiled, kind, _, _ = dryrun._compile_once(arch, shape, mesh,
                                                    cfg=reduced_config(dryrun.get_config(arch)))
        out[arch + "/" + shape] = int(compiled.memory_analysis().argument_size_in_bytes)
dryrun.make_production_mesh = lambda multi_pod=False: mesh
rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", verbose=False, roofline=False,
                      cfg_transform=reduced_config)
out["keys"] = sorted(rec)
out["memory_keys"] = sorted(rec["memory"])
out["roofline_keys"] = sorted(rec["roofline"])
print("RESULT " + json.dumps(out))
""" % (ARCHS, SHAPE_NAMES)


@pytest.fixture(scope="module")
def reference():
    env = ref_proc.ref_env()
    # first: XLA stops reading its flags at the bare intra_op_parallelism_threads
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + env["XLA_FLAGS"]
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=subprocess.PIPE, text=True, env=env)
    return ref_proc.finish(proc)


@pytest.fixture(scope="module")
def port_records():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    return {(a, s): dryrun.run_cell(a, s, mesh=mesh, cfg=reduced_config(get_config(a)),
                                    verbose=False)
            for a in ARCHS for s in SHAPE_NAMES}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_argument_bytes_equal_xla(reference, port_records, arch, shape):
    rec = port_records[(arch, shape)]
    assert rec["status"] == "ok" and rec["num_devices"] == 8
    got = round(rec["memory"]["argument_gb"] * 1e9)
    want = reference[f"{arch}/{shape}"]
    missing = sum(REF_ONLY_DECODE.values()) if rec["kind"] == "decode" else 0
    assert got + missing == want, (got, want)


def _port_keys(ref):
    top = set(ref["keys"]) - {"lower_s", "compile_s"} | {"trace_s"}
    memory = set(ref["memory_keys"]) - {"cpu_bf16_inflation_gb", "peak_tpu_adjusted_gb"} | {
        "fits_80gb"}
    return top, memory, set(ref["roofline_keys"])


@pytest.fixture(scope="module")
def full_width():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    recs = [dryrun.run_cell("jamba-1.5-large", "decode_32k", verbose=False),
            dryrun.run_cell("qwen2.5-3b", "train_4k", verbose=False)]
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    return recs, grown


def test_full_width_cells_are_ok_and_allocate_nothing(reference, full_width):
    recs, grown = full_width
    top, memory, roof = _port_keys(reference)
    for rec in recs:
        assert rec["status"] == "ok", rec
        assert set(rec) == top
        assert set(rec["memory"]) == memory
        assert set(rec["roofline"]) == roof
        assert rec["num_devices"] == 256
    jamba, qwen = recs
    # jamba's bf16 params gathered whole for the step: ~797 GB, far past one card
    assert jamba["memory"]["peak_per_device_gb"] > 700 and not jamba["memory"]["fits_80gb"]
    assert qwen["roofline"]["flops_per_dev"] > 0 and qwen["roofline"]["coll_bytes_per_dev"] > 0
    # dense compute replicated over the model axis of 16: per rank ~1/16 of the
    # global model FLOPs, at most, over what the step traces
    assert 0 < qwen["useful_flops_ratio"] < 1 / 16
    assert grown < 4e9, grown


def test_roofline_report_renders_three_tables(port_records, full_width, tmp_path):
    recs = list(port_records.values()) + list(full_width[0])
    recs.append(dryrun.run_cell("qwen2.5-3b", "long_500k", verbose=False))   # skipped
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    text = roofline_report.report(roofline_report.load(str(tmp_path)))
    assert "## Dry-run: 11 planned cells (1 skipped by design)" in text
    assert "## Roofline (single pod, per rank, one H100 SXM each)" in text
    assert "## Hillclimb selection" in text
    assert text.count("| jamba-1.5-large | decode_32k |") == 2     # both tables
    assert "skipped" in text
    for line in ("worst roofline fraction", "most collective-bound", "EN-T representative"):
        assert line in text


def test_cli_writes_one_record_a_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m", "--shape",
         "decode_32k", "--multi-pod", "--out", str(tmp_path)], capture_output=True, text=True,
        env={"PYTHONPATH": os.path.abspath(ref_proc.SRC), "OMP_NUM_THREADS": "1",
             "PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "mamba2-370m_decode_32k_mp.json").read_text())
    assert rec["status"] == "ok" and rec["num_devices"] == 512 and rec["mesh"] == "multi_pod"


@pytest.mark.parametrize("arch,kernels", [
    ("minicpm-2b", {"flash_attention": 2, "flash_attention_bwd_dq": 1,
                    "flash_attention_bwd_dkdv": 1}),
    ("mamba2-370m", {"ssd_scan": 2, "ssd_scan_bwd_state": 1, "ssd_scan_bwd_chunk": 1})])
def test_the_trace_launches_what_the_card_launches(arch, kernels):
    """A reduced train step on a 1x1 mesh, remat full, 2 microbatches:
    each layer's kernels launch as ``chip_smoke.py``'s TRAIN_RUNS counts
    them on the card (the forward kernel twice: forward and recompute),
    and no other kernel."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    cfg = reduced_config(get_config(arch))
    tcfg = TrainConfig(seq_len=128, global_batch=4, microbatch=2, remat="full")
    rec = dryrun.trace_step("train", cfg, ShapeConfig("t", "train", 128, 4),
                            AbstractMesh((1, 1), ("data", "model")), tcfg=tcfg)
    got = {k.split("/", 1)[1]: v for k, v in rec.items() if k.startswith("launches/")}
    assert got == {k: n * cfg.num_layers * 2 for k, n in kernels.items()}


def test_a_kernel_region_is_charged_its_own_count():
    """Kernel 7 at S 8, causal, on meta tensors: the 36 (query, key) pairs
    of the causal half at 4 H D FLOPs each, q, k, v read and out, lse
    written once; nothing of the plain version's [S, S] scores."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import ops as attn_ops
    trace = dryrun.StepTrace()
    q, k, v = (torch.empty((1, 2, 8, 16), device="meta") for _ in range(3))
    with trace:
        out, lse = dryrun._region(trace, attn_ops, "flash_attention", q, k, v, causal=True)
    assert out.shape == q.shape and lse.shape == (1, 2, 8)
    assert trace.flops == {"f32": 4 * 36 * 2 * 16}
    assert trace.bytes == 4 * (4 * 2 * 8 * 16 + 2 * 8)
    assert trace.launches == {"flash_attention": 1}
    assert cost.band_pairs(8, 8, 0, True, 3) == 1 + 2 + 3 * 6   # a window of 3: rows 0, 1 short


def test_every_priced_wrapper_is_swapped_and_restored():
    """The planner swaps every wrapper a kernel package prices (its
    ``ops.COSTED``), each with its meta outputs, and puts the real ones
    back."""
    pairs = dryrun.priced()
    names = {name for _, name in pairs}
    assert names == set(dryrun._OUTPUTS)
    assert {"flash_attention", "paged_attention_kernel", "ssd_scan",
            "ent_matmul_packed_fused", "int8_matmul"} <= names
    real = {(mod, name): getattr(mod, name) for mod, name in pairs}
    trace = dryrun.StepTrace()
    with dryrun.traced(trace):
        assert all(getattr(mod, name) is not fn for (mod, name), fn in real.items())
    assert all(getattr(mod, name) is fn for (mod, name), fn in real.items())


def _paged_args(device):
    q = torch.zeros((3, 4, 1, 16), dtype=torch.bfloat16, device=device)
    pool = torch.zeros((12, 4, 2, 16), dtype=torch.bfloat16, device=device)
    table = torch.tensor([[1, 2, 0, 3], [4, 5, 6, 7], [0, 0, 8, 9]], dtype=torch.int32,
                         device=device)
    pos = torch.tensor([13, 9, 14], dtype=torch.int32, device=device)
    start = torch.tensor([0, 5, 9], dtype=torch.int32, device=device)
    return (q, pool, pool, table, pos, start), {"page_size": 4}


def _masked_args(device):
    q = torch.zeros((2, 4, 3, 16), dtype=torch.bfloat16, device=device)
    k = torch.zeros((2, 2, 20, 16), dtype=torch.bfloat16, device=device)
    start = torch.tensor([0, 6], dtype=torch.int32, device=device)
    return (q, k, k, start), {"q_offset": 10, "window": 4}


def _ring_args(device):
    q = torch.zeros((2, 4, 1, 16), dtype=torch.bfloat16, device=device)
    ring = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16, device=device)
    pos = torch.tensor([3, 30], dtype=torch.int32, device=device)
    start = torch.tensor([0, 27], dtype=torch.int32, device=device)
    return (q, ring, ring, pos, start), {"window": 8}


@pytest.mark.parametrize("case", [
    # kernel 3: 10 + 5 + 6 valid columns (null pages and [start, pos] cut)
    ("paged_attention", "paged_attention_kernel", _paged_args, 21, 3 * 16),
    # kernel 2: window 4 at offsets 10..12, the second sequence from 6 on
    ("flash_attention", "flash_attention_masked", _masked_args, 2 * 12, 2 * 12),
    # the ring: 4 rows written, then 4 rows from 27 on
    ("paged_attention", "ring_decode_kernel", _ring_args, 4 + 4, 2 * 8)])
def test_a_cost_counts_what_the_data_needs(case):
    """A kernel's ``ops.cost`` on tensors whose values it can read counts
    the work their data needs; on ``meta`` (the planner's) it counts the
    most the shapes allow."""
    import importlib
    pkg, name, make, data_units, meta_units = case
    ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    unit = 4 * 4 * 16                        # 4 FLOPs a pair or row, Hq 4, D 16
    for device, units in (("cpu", data_units), ("meta", meta_units)):
        args, kw = make(device)
        (_, flops, nbytes), = ops.cost(name, *args, **kw)
        assert flops == {"bf16": units * unit}, (device, flops)
        assert nbytes > 0


def test_a_serving_step_on_a_mesh_gathers_nothing():
    """A serving rank gathers its kept params once, before its steps: the
    decode and prefill records of reduced qwen2.5-3b on a (2, 4) mesh carry
    no collective, and the step holds the params whole."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import cached_params
    cfg = reduced_config(get_config("qwen2.5-3b"))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    whole = sum(t.numel() * t.element_size() for t in dryrun._tensors(
        cached_params(cfg, True, False)))
    for kind, shape in (("decode", "decode_32k"), ("prefill", "prefill_32k")):
        rec = dryrun.trace_step(kind, cfg, SHAPES[shape], mesh)
        assert rec["records"] == [], (kind, rec["records"][:3])
        assert rec["held"] > whole
