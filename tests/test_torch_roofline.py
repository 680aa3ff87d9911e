"""The port's ``core/roofline.py`` against the reference's, and the
planner's collective records against a gloo world's.

The five ring models reproduce ``tests/test_roofline.py``'s numbers from
the equivalent collective records (the reference's all-gather there is
an XLA:CPU f32 buffer of a bf16 collective, so its record carries the
bf16 bytes); the terms, bottleneck and fraction cases carry over on the
H100 constants; a group within one node of 8 rides NVLink, one across
nodes the network; ``model_flops`` equals the reference's for every arch
x shape.  Then one ``_sharded_step`` of reduced qwen2.5-3b and reduced
mixtral-8x7b (microbatches, remat full: its recompute replays the MoE
layer's collectives) on a gloo world of 4 as a (2, 2) mesh: the bytes
each rank's collectives move (``collectives.moved``), by kind and group
size, equal the planner's records for that cell (``launch/dryrun.py``'s
``trace_step`` on an ``AbstractMesh`` at that rank, on ``meta``).
Exact equality throughout, but for the float terms (rel 1e-9).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_worker as dw  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import roofline as ref_rl  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core import roofline as rl  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402

ROWS, SEQ = 4, 16
# name -> (arch, microbatch in global rows, remat)
RUNS = {"dense": ("qwen2.5-3b", 2, "none"), "moe": ("mixtral-8x7b", 2, "full")}


class TestCollectiveRecords:
    def test_ring_models_from_records(self):
        """``tests/test_roofline.py``'s HLO lines as records (kind, result
        bytes on a rank, group): a group given by size is one node's."""
        records = [
            ("all-gather", 128 * 4096 * 2, 16),         # bf16 (XLA:CPU showed f32)
            ("all-reduce", 512 * 512 * 2, 256),
            ("reduce-scatter", 64 * 64 * 4, 4),
            ("collective-permute", 32 * 32 * 2, 2),
            ("all-to-all", 16 * 16 * 4, 8),
        ]
        out = rl.collective_bytes(records)
        assert out["all-gather"] == pytest.approx(128 * 4096 * 4 * 0.5 * 15 / 16, rel=1e-6)
        assert out["all-reduce"] == pytest.approx(2 * 512 * 512 * 2 * 255 / 256, rel=1e-6)
        assert out["reduce-scatter"] == pytest.approx(64 * 64 * 4 * 3, rel=1e-6)
        assert out["collective-permute"] == pytest.approx(32 * 32 * 2)
        assert out["all-to-all"] == pytest.approx(16 * 16 * 4 * 7 / 8, rel=1e-6)
        assert out["counts"]["all-reduce"] == 1
        assert out["cross_node"] == 0.0

    def test_a_group_of_one_moves_nothing(self):
        out = rl.collective_bytes([("all-reduce", 1024, 1), ("all-gather", 1024, (5,))])
        assert out["total"] == 0.0 and out["counts"]["all-reduce"] == 0

    def test_nodes_are_rank_div_8(self):
        inside = rl.collective_bytes([("all-gather", 800, tuple(range(8, 16)))])
        across = rl.collective_bytes([("all-gather", 800, (0, 8))])
        assert inside["cross_node"] == 0.0 and inside["total"] == 700.0
        assert across["cross_node"] == across["total"] == 400.0
        r = rl.Roofline(flops=0, hbm_bytes=0, coll_bytes=inside["total"] + across["total"],
                        coll_detail={}, peak_memory_bytes=0,
                        coll_cross_bytes=across["cross_node"])
        assert r.collective_s == pytest.approx(700 / rl.NVLINK_BW + 400 / rl.NET_BW, rel=1e-12)


class TestRooflineTerms:
    def test_bottleneck_and_fraction(self):
        r = rl.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=0,
                        coll_detail={}, peak_memory_bytes=0)
        assert r.compute_s == pytest.approx(1.0)
        assert r.memory_s == pytest.approx(2.0)
        assert r.bottleneck == "memory"
        assert r.roofline_fraction() == pytest.approx(0.5)

    def test_perfect_overlap_total(self):
        r = rl.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=450e9 * 3,
                        coll_detail={}, peak_memory_bytes=0)
        assert r.total_s == pytest.approx(3.0)
        assert r.bottleneck == "collective"

    def test_compute_by_operand_type(self):
        r = rl.Roofline(flops=989e12 + 1979e12 + 67e12, hbm_bytes=0, coll_bytes=0,
                        coll_detail={}, peak_memory_bytes=0,
                        flops_by_type={"bf16": 989e12, "int8": 1979e12, "f32": 67e12})
        assert r.compute_s == pytest.approx(3.0)

    def test_as_dict_has_the_reference_keys(self):
        kw = dict(flops=1.0, hbm_bytes=1.0, coll_bytes=0.0, coll_detail={"counts": {}},
                  peak_memory_bytes=0.0)
        assert set(rl.Roofline(**kw).as_dict()) == set(ref_rl.Roofline(**kw).as_dict())

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_model_flops_matches_reference(self, arch):
        for name in SHAPES:
            assert rl.model_flops(get_config(arch), SHAPES[name]) == ref_rl.model_flops(
                ref_get_config(arch), REF_SHAPES[name])


@pytest.fixture(scope="module")
def world22(tmp_path_factory):
    return dw.run_world("collectives", 4, tmp_path_factory.mktemp("coll22"), shape=(2, 2),
                        runs=RUNS, rows=ROWS, seq=SEQ)


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("rank", range(4))
def test_planner_records_equal_the_gloo_worlds_bytes(world22, name, rank):
    arch, mb, remat = RUNS[name]
    cfg = dw.step_config(arch)
    tcfg = TrainConfig(seq_len=SEQ, global_batch=ROWS, microbatch=mb, remat=remat)
    rec = dryrun.trace_step("train", cfg, ShapeConfig("t", "train", SEQ, ROWS),
                            AbstractMesh((2, 2), ("data", "model"), rank=rank), tcfg=tcfg)
    planned = {}
    for kind, nbytes, ranks in rec["records"]:
        assert rank in ranks
        key = f"{name}/{kind}/{len(ranks)}"
        planned[key] = planned.get(key, 0) + nbytes
    got = {k: int(v) for k, v in world22[rank].items() if k.startswith(name + "/")}
    assert got == planned
    assert any("all-gather" in k for k in got) and any("all-reduce" in k for k in got)
