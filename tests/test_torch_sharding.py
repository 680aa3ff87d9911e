"""The port's sharding rules and layouts against the reference's.

Every case of ``tests/test_sharding.py`` with the same expected specs (a
grouped reference leaf [G, ...] is the port's per-layer leaf without its
leading ``None``), then the port's ``param_pspec`` / ``cache_pspec`` /
``batch_pspec`` equal to the reference's for every leaf of every arch in
``ARCH_IDS`` (shapes from the reference's ``jax.eval_shape`` trees at full
size), under the three profiles on the (16, 16) and (2, 16, 16) abstract
meshes, and for the EN-T packed, legacy 4-plane and w8a8 records of a
quantized arch; the port's own param trees (reduced configs) laid out as
the reference's; ``local_shard`` / ``gather`` round trips and the mesh's
groups on a gloo world of 4, a compound axis included.  Exact equality
throughout.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh as RefAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_dist_worker as dw  # noqa: E402
from repro import sharding as ref_shd  # noqa: E402
from repro.configs import ARCH_IDS, QuantConfig as RefQuantConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

PROFILES = ("2d", "fsdp", "serve_tp")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(sizes, names):
    try:  # newer jax: AbstractMesh(axis_sizes, axis_names)
        return RefAbstractMesh(sizes, names)
    except TypeError:  # jax<=0.4.x: AbstractMesh(((name, size), ...))
        return RefAbstractMesh(tuple(zip(names, sizes)))


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    sizes, names = MESHES[request.param]
    return _ref_mesh(sizes, names), AbstractMesh(sizes, names)


def _port(path: str, shape):
    """The reference's (path, shape) as the port's, and how many leading
    entries of the reference's spec to drop: ``groups/<i>/...`` [G, ...]
    is ``layers/<i>/...`` [...]."""
    parts = path.split("/")
    if parts[0] == "groups":
        return "/".join(["layers"] + parts[1:]), tuple(shape[1:]), 1
    return path, tuple(shape), 0


# --- the reference's rule tests ------------------------------------------------

# (reference path, reference shape, mesh, profile, expected reference spec)
RULE_CASES = {
    "column_parallel": ("groups/0/mixer/wq/kernel", (32, 4096, 4096), "16x16", "2d",
                        P(None, "data", "model")),
    "row_parallel": ("groups/0/mixer/wo/kernel", (32, 4096, 4096), "16x16", "2d",
                     P(None, "model", "data")),
    "embedding": ("embed/embedding", (152064, 8192), "16x16", "2d", P("model", "data")),
    "divisibility_fallback": ("groups/0/mixer/wk/kernel", (40, 2304, 100), "16x16", "2d",
                              P(None, "data", None)),
    "norm_replicated": ("groups/0/ffn_norm/scale", (32, 4096), "16x16", "2d", P(None, None)),
    "moe_experts_ep_when_divisible": ("groups/0/ffn/wi_gate", (40, 16, 6144, 10752), "16x16",
                                      "2d", P(None, "model", "data", None)),
    "moe_experts_tp_when_not": ("groups/0/ffn/wi_gate", (32, 8, 4096, 14336), "16x16", "2d",
                                P(None, None, "data", "model")),
    "multipod_uses_compound_data": ("groups/0/mixer/wq/kernel", (32, 4096, 4096), "2x16x16",
                                    "2d", P(None, ("pod", "data"), "model")),
    "serve_tp_stationary": ("groups/0/mixer/wq/kernel", (32, 4096, 4096), "16x16", "serve_tp",
                            P(None, None, "model")),
    "fsdp_rows_over_all": ("groups/0/mixer/wq/kernel", (48, 6144, 6144), "16x16", "fsdp",
                           P(None, ("data", "model"), None)),
    "fsdp_small_dim_falls_back": ("groups/0/mixer/wq/kernel", (2, 128, 64), "16x16", "fsdp",
                                  P(None, None, None)),
    "q_like_kernel": ("groups/0/mixer/wq/q", (32, 4096, 4096), "16x16", "serve_tp",
                      P(None, None, "model")),
    "planes_lead_axis": ("groups/0/mixer/wq/planes", (32, 4, 4096, 4096), "16x16", "serve_tp",
                         P(None, None, None, "model")),
    "packed_planes_lead_axis": ("groups/0/mixer/wq/planes_packed", (32, 2, 4096, 4096),
                                "16x16", "serve_tp", P(None, None, None, "model")),
    "scale_follows_out_channel": ("groups/0/mixer/wq/scale", (32, 1, 4096), "16x16",
                                  "serve_tp", P(None, None, "model")),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_reference_rule_case(case):
    path, shape, mesh, profile, want = RULE_CASES[case]
    sizes, names = MESHES[mesh]
    assert ref_shd.param_pspec(path, shape, _ref_mesh(sizes, names), profile) == want
    ppath, pshape, drop = _port(path, shape)
    got = shd.param_pspec(ppath, pshape, AbstractMesh(sizes, names), profile)
    assert got == tuple(want)[drop:]


# (reference path or None for a batch, reference shape, expected reference spec)
BATCH_CACHE_CASES = {
    "batch_sharded_on_data": (None, (256, 4096), P("data", None)),
    "batch1_replicates": (None, (1, 524288), P(None, None)),
    "kv_cache_seq_on_model": ("layers/0/k", (80, 128, 32768, 8, 128),
                              P(None, "data", "model", None, None)),
    "ssd_cache_heads_on_model": ("layers/0/ssd", (9, 1, 256, 64, 128),
                                 P(None, None, "model", None, None)),
    "kv_cache_batch1": ("layers/0/k", (9, 1, 524288, 8, 128), P(None, None, "model", None, None)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CACHE_CASES))
def test_reference_batch_and_cache_case(case):
    path, shape, want = BATCH_CACHE_CASES[case]
    ref_mesh, mesh = _ref_mesh(*MESHES["16x16"]), AbstractMesh(*MESHES["16x16"])
    if path is None:
        assert ref_shd.batch_pspec(shape, ref_mesh) == want
        assert shd.batch_pspec(shape, mesh) == tuple(want)
    else:
        assert ref_shd.cache_pspec(path, shape, ref_mesh) == want
        assert shd.cache_pspec(path, shape[1:], mesh) == tuple(want)[1:]


# --- every leaf of every arch --------------------------------------------------

def _leaves(tree):
    return [(ref_shd._path_str(p), leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _check_params(tree, meshes, profiles=PROFILES):
    ref_mesh, mesh = meshes
    n = 0
    for path, shape in _leaves(tree):
        ppath, pshape, drop = _port(path, shape)
        for profile in profiles:
            want = tuple(ref_shd.param_pspec(path, shape, ref_mesh, profile))
            assert shd.param_pspec(ppath, pshape, mesh, profile) == want[drop:], (path, profile)
            n += 1
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_param_leaf_equals_reference(arch, meshes):
    shapes = jax.eval_shape(ref_build(ref_get_config(arch)).init, jax.random.PRNGKey(0))
    assert _check_params(shapes, meshes) > 0


def _legacy_planes(tree):
    """w8a8 records with legacy 4-plane ``planes`` [G, 4, I, O] beside q."""
    if isinstance(tree, dict):
        out = {k: _legacy_planes(v) for k, v in tree.items()}
        if "q" in tree:
            q = tree["q"]
            out["planes"] = jax.ShapeDtypeStruct(q.shape[:-2] + (4,) + q.shape[-2:], q.dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_legacy_planes(v) for v in tree)
    return tree


@pytest.mark.parametrize("record", ["ent_packed", "legacy_planes", "w8a8"])
def test_every_quantized_record_leaf_equals_reference(record, meshes):
    model = ref_build(ref_get_config("qwen2.5-3b"))
    qcfg = RefQuantConfig(enabled=True, ent_encode=record == "ent_packed")
    shapes = jax.eval_shape(lambda k: ref_quantize(model.init(k), qcfg), jax.random.PRNGKey(0))
    if record == "legacy_planes":
        shapes = _legacy_planes(shapes)
    names = {p.split("/")[-1] for p, _ in _leaves(shapes)}
    assert {"q", "scale"} <= names
    assert ("planes_packed" in names) == (record == "ent_packed")
    assert ("planes" in names) == (record == "legacy_planes")
    assert _check_params(shapes, meshes) > 0


# (arch, cache variant): "auto" is the ring for windowed archs and dense
# rows otherwise, "int8_kv" the same with int8 rows and bf16 scales,
# "paged" the page pools (windowed archs serve through the ring only)
CACHE_CASES = [(a, v) for a in ARCH_IDS for v in ("auto", "int8_kv", "paged")
               if not (v == "paged" and get_config(a).sliding_window)]


@pytest.mark.parametrize("arch,variant", CACHE_CASES)
def test_every_cache_and_batch_leaf_equals_reference(arch, variant, meshes):
    ref_mesh, mesh = meshes
    model = ref_build(ref_get_config(arch), kv_quant=variant == "int8_kv")
    kind = "paged" if variant == "paged" else "auto"
    shapes = jax.eval_shape(lambda: model.init_cache(64, 4096, kind=kind))
    leaves = _leaves(shapes)
    assert any(p.split("/")[-1] in ("k", "ssd") for p, _ in leaves)
    for path, shape in leaves:
        ppath, pshape, drop = _port(path.replace("layers", "groups", 1)
                                    if path.startswith("layers/") else path, shape)
        want = tuple(ref_shd.cache_pspec(path, shape, ref_mesh))
        assert shd.cache_pspec(ppath, pshape, mesh) == want[drop:], path
    for shape in ((64, 4096), (1, 4096), (64, 4096, 1024), (48, 16)):
        assert shd.batch_pspec(shape, mesh) == tuple(ref_shd.batch_pspec(shape, ref_mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_param_tree_is_laid_out_as_the_reference(arch):
    """The port's own (reduced) param tree: each layer leaf's spec on a (2, 4)
    mesh equals the reference's for that leaf of the same group position."""
    sizes, names = (2, 4), ("data", "model")
    ref_mesh, mesh = _ref_mesh(sizes, names), AbstractMesh(sizes, names)
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced_config(get_config(arch))
    ref_tree = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    port = Model(cfg, device="cpu").init(gen)
    n_group = len(rcfg.group)
    want = {}
    for path, shape in _leaves(ref_tree):
        parts = path.split("/")
        spec = tuple(ref_shd.param_pspec(path, shape, ref_mesh, "2d"))
        if parts[0] == "groups":
            for g in range(shape[0]):
                layer = g * n_group + int(parts[1])
                want["/".join(["layers", str(layer)] + parts[2:])] = spec[1:]
        else:
            want[path] = spec
    got = dict(shd.tree_paths(shd.params_shardings(port, mesh)))
    paths = dict(shd.tree_paths(port))
    assert set(paths) == set(want)
    for path, t in paths.items():
        assert shd.param_pspec(path, t.shape, mesh) == want[path], path
    assert len(got) >= len(paths)


# --- layouts on a gloo world of 4 ------------------------------------------------

LAYOUT_SPECS = [((8, 6), ("data", None)), ((8, 6), (None, "model")),
                ((8, 6), ("data", "model")), ((8, 6), ("model", "data")),
                ((8, 6), (("data", "model"), None)), ((8, 6), (("model", "data"), None)),
                ((4, 6, 8), (None, None, ("data", "model"))), ((5, 3), (None, None))]


@pytest.fixture(scope="module")
def layout_world(tmp_path_factory):
    return dw.run_world("layout", 4, tmp_path_factory.mktemp("layout"), shape=(2, 2),
                        axes=("data", "model"), specs=LAYOUT_SPECS)


def _block(full, spec, coords):
    """This rank's block by hand: a compound entry splits major-to-minor in
    the order it lists its axes."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * 2 + coords[a], n * 2
        size = full.shape[dim] // n
        full = np.take(full, range(idx * size, (idx + 1) * size), axis=dim)
    return full


def test_local_shard_and_gather_round_trip(layout_world):
    for rank, res in enumerate(layout_world):
        coords = dict(zip(("data", "model"), res["coords"]))
        assert coords == {"data": rank // 2, "model": rank % 2}   # row-major
        for i, (shape, spec) in enumerate(LAYOUT_SPECS):
            full = layout_world[0][f"{i}/gathered"]
            assert full.shape == shape
            assert np.array_equal(res[f"{i}/gathered"], full), (rank, spec)
            assert np.array_equal(res[f"{i}/local"], _block(full, spec, coords)), (rank, spec)
        assert bool(res["tree_equal"])


def test_mesh_groups_and_refusals(layout_world):
    for rank, res in enumerate(layout_world):
        d, m = rank // 2, rank % 2
        assert list(res["group/data"]) == [m, 2 + m]
        assert list(res["group/model"]) == [2 * d, 2 * d + 1]
        assert list(res["group/data,model"]) == [0, 1, 2, 3]
        assert int(res["refused"]) == 3    # a 2x2x2 mesh, 16x16, 2x16x16 on a world of 4
    groups = [k for k in layout_world[0] if k.startswith("group/")]
    assert len(groups) == len(list(itertools.chain.from_iterable(
        itertools.combinations(("data", "model"), n) for n in (1, 2))))
