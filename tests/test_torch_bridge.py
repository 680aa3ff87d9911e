"""Port scaffolding: import isolation, device resolution, the numpy bridge,
and the kernel wrappers' CPU dispatch."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ent_matmul.ent_matmul import (  # noqa: E402
    ent_matmul, ent_matmul_packed, ent_matmul_packed_fused)
from repro_torch.kernels.ent_matmul.ref import (  # noqa: E402
    ent_matmul_ref, ent_packed_fused_ref, ent_packed_matmul_ref, quantize_rows)
from repro_torch.kernels.ent_matmul.ops import row_scale  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked  # noqa: E402
from repro_torch.kernels.flash_attention.ref import masked_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert len(names) >= 77, names
        for n in ("checkpoint.checkpointer", "core.encoding", "core.gates", "core.hwmodel",
                  "core.networks", "core.soc", "core.paper_tables", "core.fit_hwmodel"):
            assert "repro_torch." + n in names, names
        assert "repro_torch.kernels.int8_matmul.int8_matmul" in names, names
        assert "repro_torch.launch.train" in names, names
        assert "repro_torch.runtime.server" in names, names
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": _SRC, "PATH": "/usr/bin:/bin",
                                         "OMP_NUM_THREADS": "1"},
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_scripts_import_no_jax_and_nothing_of_repro():
    """chip_smoke.py and the port's examples (examples/torch_*.py) name no
    module of JAX or of the reference in any import."""
    import ast
    import glob
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    paths = [os.path.join(root, "chip_smoke.py"),
             *sorted(glob.glob(os.path.join(root, "examples", "torch_*.py")))]
    assert len(paths) >= 5
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro", "benchmarks"), \
                    (path, m)


def test_configs_are_copies_of_the_reference():
    for arch in ("qwen2.5-3b", "mixtral-8x7b", "jamba-1.5-large"):
        ref, port = get_config(arch), port_get_config(arch)
        assert repr(reduced_config(ref)).replace("repro.", "") == \
            repr(port_reduced(port)).replace("repro_torch.", "")
        assert ref.param_count() == port.param_count()


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is valid")
    cfg = port_reduced(port_get_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"groups": ({"w": np.zeros((1, 2))},)})
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2.5-3b", "--smoke", "--engine",
                    "--quantize", "--no-prefix-cache"])
    assert resolve_device("cpu").type == "cpu"


def test_bridge_unstacks_groups_bit_exact():
    cfg = reduced_config(get_config("qwen2.5-3b"))
    ref_params = ref_build(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    port = bridge.params_from_numpy(tree, "cpu")
    assert len(port["layers"]) == cfg.num_layers
    np.testing.assert_array_equal(port["embed"]["embedding"].numpy(),
                                  tree["embed"]["embedding"])
    for g in range(cfg.num_groups):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                port["layers"][g]["mixer"][name]["kernel"].numpy(),
                tree["groups"][0]["mixer"][name]["kernel"][g])
        np.testing.assert_array_equal(
            port["layers"][g]["ffn"]["wi_gate"]["kernel"].numpy(),
            tree["groups"][0]["ffn"]["wi_gate"]["kernel"][g])


def test_bridge_carries_quantized_trees_bit_exact():
    """int8 ``q``, ``planes`` and ``planes_packed`` and f32 ``scale``
    leaves of a reference-quantized tree cross bit for bit."""
    from repro.configs import QuantConfig
    from repro.kernels.ent_matmul.ops import encode_weights
    from repro.quant.quantize import quantize_params
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(2))
    for ent in (True, False):
        tree = quantize_params(params, QuantConfig(enabled=True, ent_encode=ent))
        wq = dict(tree["groups"][0]["mixer"]["wq"])
        if not ent:    # a legacy 4-plane record, as old checkpoints hold
            wq["planes"] = jax.vmap(encode_weights)(wq["q"])
            tree["groups"][0]["mixer"]["wq"] = wq
        port = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
        for g in range(cfg.num_groups):
            rec = port["layers"][g]["mixer"]["wq"]
            assert set(rec) == set(wq)
            for key, leaf in wq.items():
                want = np.asarray(leaf[g])
                assert str(rec[key].dtype).endswith(str(want.dtype))
                np.testing.assert_array_equal(rec[key].numpy(), want)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    counters = (ent_matmul_packed_fused, ent_matmul_packed, ent_matmul,
                flash_attention_masked, paged_attention_kernel)
    launches = [f.launches for f in counters]

    x = torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(-10, 11, (2, 70, 9)).astype(np.int8))
    sw = torch.from_numpy(rng.random((1, 9)).astype(np.float32))
    assert torch.equal(ent_matmul_packed_fused(x, packed, row_scale(x), sw),
                       ent_packed_fused_ref(x, packed, sw))
    xq, sx = quantize_rows(x)
    assert torch.equal(ent_matmul_packed(xq, packed, sx, sw),
                       ent_packed_matmul_ref(xq, packed, sx, sw))
    planes = torch.from_numpy(rng.integers(-2, 3, (4, 70, 9)).astype(np.int8))
    assert torch.equal(ent_matmul(xq, planes, sx, sw), ent_matmul_ref(xq, planes, sx, sw))

    q = torch.from_numpy(rng.standard_normal((1, 4, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 6, 16)).astype(np.float32))
    start = torch.tensor([2], dtype=torch.int32)
    assert torch.equal(flash_attention_masked(q, k, k, start),
                       masked_attention_ref(q, k, k, start=start))

    pool = torch.from_numpy(rng.standard_normal((5, 4, 2, 16)).astype(np.float32))
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([6, 3], dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    qd = q[:, :, :1].expand(2, 4, 1, 16).contiguous()
    got = paged_attention_kernel(qd, pool, pool, table, pos, z, page_size=4)
    assert torch.equal(got, paged_attention_ref(qd, pool, pool, table, pos, z,
                                                page_size=4))
    assert [f.launches for f in counters] == launches


def test_kernel_wrappers_refuse_bad_operands():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        ent_matmul_packed_fused(x, torch.zeros((2, 7, 3), dtype=torch.int8),
                                torch.ones((4, 1)), torch.ones((1, 3)))
    with pytest.raises(TypeError):
        ent_matmul_packed_fused(x, torch.zeros((2, 8, 3), dtype=torch.int32),
                                torch.ones((4, 1)), torch.ones((1, 3)))
    pool = torch.zeros((3, 4, 1, 16))
    with pytest.raises(NotImplementedError):
        paged_attention_kernel(torch.zeros((1, 2, 1, 16)), pool, pool,
                               torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               k_scales=pool[..., :1], v_scales=pool[..., :1],
                               page_size=4)


def test_flash_wrapper_returns_q_dtype():
    # as the Pallas kernel: the output is in q's dtype, softmax in f32
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    start = torch.tensor([1], dtype=torch.int32)
    got = flash_attention_masked(q, k[:, :2], v[:, :2], start)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, masked_attention_ref(q, k[:, :2], v[:, :2],
                                                 start=start).to(torch.bfloat16))


def test_kernel_library_key_covers_shared_headers(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    assert set(_build.ENTRY_POINTS) == set(_build.SOURCES)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before
