"""The traffic generators: deterministic per seed, lengths inside the stated
ranges, and the same sizes for every seed."""

import collections

import numpy as np
import pytest

from port_bench import cell as cells
from port_bench.traffic import closed_loop, generator as G, token_stream

SEEDS = [0, 7, 2**31 + 5, -3, 10**30]


@pytest.fixture(scope="module")
def longdoc():
    return cells.load("qwen-ent.longdoc").traffic


def _sizes(queues):
    return (collections.Counter(len(r.prompt) for q in queues for r in q),
            collections.Counter(r.max_new for q in queues for r in q))


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_is_a_function_of_the_seed(longdoc, seed):
    small = dict(longdoc, requests_per_client=2)
    a = closed_loop.requests(small, seed, 1000)
    b = closed_loop.requests(small, seed, 1000)
    assert [[(r.prompt, r.max_new) for r in q] for q in a] == \
           [[(r.prompt, r.max_new) for r in q] for q in b]


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_lengths_in_range_and_rounds_alike(longdoc, seed):
    small = dict(longdoc, requests_per_client=3)
    queues = closed_loop.requests(small, seed, 151936)
    assert len(queues) == longdoc["clients"]
    p, o = longdoc["prompt_len"], longdoc["output_len"]
    for q in queues:
        assert len(q) == 3
        for r in q:
            assert p["lo"] <= len(r.prompt) <= p["hi"]
            assert o["lo"] <= r.max_new <= o["hi"]
            assert all(0 <= t < 151936 for t in r.prompt[:64])
    # every round holds the same multiset of sizes
    rounds = [sorted(len(q[i].prompt) for q in queues) for i in range(3)]
    assert rounds[0] == rounds[1] == rounds[2]


def test_seeds_change_order_and_ids_not_sizes(longdoc):
    small = dict(longdoc, requests_per_client=2)
    a, b = closed_loop.requests(small, 1, 1000), closed_loop.requests(small, 2, 1000)
    assert _sizes(a) == _sizes(b)
    assert [r.prompt for q in a for r in q] != [r.prompt for q in b for r in q]


def test_quantiles_are_stratified():
    vals = G.quantiles({"dist": "log_uniform", "lo": 2048, "hi": 8192}, 16)
    assert vals == sorted(vals) and vals[0] > 2048 and vals[-1] < 8192
    # log-uniform: the median stratum sits near the geometric mean
    assert abs(np.log(vals[7] * vals[8]) / 2 - np.log(4096)) < 0.1
    u = G.quantiles({"dist": "uniform", "lo": 16, "hi": 64}, 16)
    assert u[0] >= 16 and u[-1] <= 64 and len(set(u)) == 16


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_token_stream_deterministic_and_fresh_per_step(seed):
    spec = cells.load("mamba2.train4k").traffic
    small = dict(spec, global_batch=4, seq_len=64)
    a0, b0 = token_stream.batch(small, seed, 50280, 0), token_stream.batch(small, seed, 50280, 0)
    a1 = token_stream.batch(small, seed, 50280, 1)
    assert a0.shape == (4, 65) and a0.dtype == np.int32
    assert np.array_equal(a0, b0) and not np.array_equal(a0, a1)
    assert a0.min() >= 0 and a0.max() < 50280
    assert len({tuple(r) for r in a0}) == 4        # rows all differ


def test_token_stream_matches_the_programs_source():
    """The frozen copy draws what ``SyntheticSource`` draws for the same seed."""
    from repro_torch.data.pipeline import SyntheticSource

    spec = dict(cells.load("mamba2.train4k").traffic, global_batch=2, seq_len=32)
    ours = token_stream.batch(spec, 11, 50280, 3)
    theirs = SyntheticSource(50280, seed=G.derive(11, 3)).batch(3, 0, 2, 32)
    assert np.array_equal(ours, theirs)


def test_closed_loop_arrivals_follow_each_client():
    spec = dict(cells.load("qwen-ent.longdoc").traffic, clients=3, requests_per_client=2)
    arr = closed_loop.Arrivals(spec, 5, 1000)
    first = arr.start()
    assert [r.client for r in first] == [0, 1, 2] and all(r.round == 0 for r in first)
    (nxt,) = arr.after(first[1], 1.0)
    assert (nxt.client, nxt.round) == (1, 1)
    assert arr.due(100.0) == []
    with pytest.raises(RuntimeError, match="ran out"):
        arr.after(nxt, 2.0)


def test_kinds_are_found_by_the_generator_name():
    for cell in ("qwen-ent.longdoc", "mamba2.train4k"):
        spec = cells.load(cell).traffic
        assert G.kind(spec).__name__ == f"port_bench.traffic.{spec['generator']}"
    with pytest.raises(ValueError, match="synthetic_zipf"):
        token_stream.batch(dict(cells.load("mamba2.train4k").traffic, source="other"), 1, 10, 0)
