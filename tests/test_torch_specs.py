"""The port's ``launch/specs.input_specs`` against the reference's.

For all 10 archs x 4 shapes, plain and ``quantized=True`` (the w8a8
records; ``kv_quant=True`` on the decode cells), every leaf of the
port's (params, opt_state, batch) / (params, batch) / (params, cache,
tokens) trees equals the reference's ``jax.eval_shape`` leaf in shape and
dtype: a grouped reference leaf [G, ...] is G port layers' leaves
(layer ``g * len(group) + i`` is group position i's index g), and a
decode cache compares layer by layer with the port's cache objects'
tensors.  Every port leaf is a ``meta`` tensor.  The one leaf one side
holds and the other does not is the decode cache's ``"pos"`` (the
reference's int32 scalar; the port's Python int).  ``moe_rank_major``
runs once under a (1, 2) abstract mesh.  Exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh as RefAbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.specs import CACHE_FIELDS, input_specs  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

CASES = [(a, s, q) for a in ARCH_IDS for s in SHAPES for q in (False, True)]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _leaf(path, ref, port, seen):
    assert isinstance(port, torch.Tensor), (path, type(port))
    assert port.device.type == "meta", path
    assert tuple(port.shape) == tuple(ref.shape), (path, tuple(port.shape), ref.shape)
    assert _dtype(port) == _dtype(ref), (path, _dtype(port), _dtype(ref))
    seen.append(path)


def _tree(path, ref, port, seen):
    """``ref`` (reference layout) against ``port`` (the port's)."""
    if isinstance(ref, dict):
        if "groups" in ref:   # a params tree: unstack [G] into the port's layers
            assert set(port) == (set(ref) - {"groups"}) | {"layers"}, (path, sorted(port))
            n = len(ref["groups"])
            g_count = len(port["layers"]) // n
            assert len(port["layers"]) == n * g_count
            for i, pos in enumerate(ref["groups"]):
                for g in range(g_count):
                    _grouped(f"{path}/groups/{i}[{g}]", pos, port["layers"][g * n + i], g,
                             seen)
            for k in ref:
                if k != "groups":
                    _tree(f"{path}/{k}", ref[k], port[k], seen)
            return
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            _tree(f"{path}/{k}", ref[k], port[k], seen)
        return
    _leaf(path, ref, port, seen)


def _grouped(path, ref, port, g, seen):
    """A group position's reference subtree ([G, ...] leaves) against one
    port layer."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            _grouped(f"{path}/{k}", ref[k], port[k], g, seen)
        return
    _leaf(path, jax.ShapeDtypeStruct(ref.shape[1:], ref.dtype), port, seen)


def _cache(ref, port, seen):
    """The reference's {"layers": (per group position, [G, ...] fields),
    "pos"} against the port's {"layers": [cache per layer], "pos"}: the
    leaves only one side holds, by name and bytes."""
    n = len(ref["layers"])
    g_count = len(port["layers"]) // n
    assert len(port["layers"]) == n * g_count
    for i, rc in enumerate(ref["layers"]):
        assert type(rc).__name__ == type(port["layers"][i]).__name__, (i, type(rc))
        for g in range(g_count):
            pc = port["layers"][g * n + i]
            for name in CACHE_FIELDS:
                r, p = getattr(rc, name, None), getattr(pc, name, None)
                assert (r is None) == (p is None), (i, g, name)
                if r is not None:
                    _leaf(f"cache/{i}[{g}]/{name}", jax.ShapeDtypeStruct(r.shape[1:], r.dtype),
                          p, seen)
    assert isinstance(port["pos"], int)
    return {"pos": int(np.dtype(ref["pos"].dtype).itemsize * np.prod(ref["pos"].shape))}


@pytest.mark.parametrize("arch,shape,quantized", CASES)
def test_input_specs_match_reference(arch, shape, quantized):
    kvq = quantized and SHAPES[shape].kind == "decode"
    _, rargs, rkind = ref_input_specs(arch, shape, quantized=quantized, kv_quant=kvq)
    _, pargs, pkind = input_specs(arch, shape, quantized=quantized, kv_quant=kvq)
    assert pkind == rkind and len(pargs) == len(rargs)
    seen = []
    if rkind == "decode":
        _tree("params", rargs[0], pargs[0], seen)
        assert _cache(rargs[1], pargs[1], seen) == {"pos": 4}
        _leaf("tokens", rargs[2], pargs[2], seen)
    else:
        for i, (r, p) in enumerate(zip(rargs, pargs)):
            _tree(f"arg{i}", r, p, seen)
    assert len(seen) > 10
    if quantized and rkind != "train":   # a train cell keeps float params
        assert any(p.endswith("/q") for p in seen), "no w8a8 record compared"


def test_moe_rank_major_under_a_1x2_mesh():
    """mixtral-8x7b's serving params laid out rank-major for a model axis
    of 2 (pure expert parallelism: 4 of 8 experts a rank, the stacks as
    they are), decode_32k, against the reference's under its (1, 2)
    abstract mesh."""
    try:
        rmesh = RefAbstractMesh((1, 2), ("data", "model"))
    except TypeError:   # jax<=0.4.x
        rmesh = RefAbstractMesh((("data", 1), ("model", 2)))
    pmesh = AbstractMesh((1, 2), ("data", "model"))
    _, rargs, _ = ref_input_specs("mixtral-8x7b", "decode_32k", dist=(rmesh, "data"),
                                  moe_rank_major=True)
    _, pargs, _ = input_specs("mixtral-8x7b", "decode_32k", dist=(pmesh, "data"),
                              moe_rank_major=True)
    seen = []
    _tree("params", rargs[0], pargs[0], seen)
    assert any("ffn/wi_gate" in p for p in seen)


def test_meta_init_makes_shapes_from_a_cpu_generator():
    """A model on ``meta`` draws from a CPU generator and makes shapes only
    (``resolve_device`` lets ``meta`` through, for planning)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=1)
    params = Model(cfg, device="meta").init(torch.Generator())
    assert params["embed"]["embedding"].device.type == "meta"
    assert params["layers"][0]["mixer"]["wq"]["kernel"].device.type == "meta"
