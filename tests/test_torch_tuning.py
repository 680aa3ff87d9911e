"""The port's launch-plan table (``repro_torch/kernels/tuning.py``) against
the reference's block-size table (``repro/kernels/tuning.py``): the
reference's own cases on the port's families, parity where the two
modules share code and behaviour (bucketing, ``_fit``, the key form, the
resolution order, a fake-bench ``autotune``'s winner and file, corrupt
caches), the heuristics equal to the wrappers' plans on 132-, 114- and
78-SM cards, every candidate valid, and the wrappers reading the table on
card tensors (meta tensors and a recorder in place of the built library)
and never on CPU tensors.  Each test's cache lives under ``tmp_path``."""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import tuning as ref_tuning  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul as im  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402

SMS = 132
CARDS = (132, 114, 78)   # SMs of an H100 SXM, an H100 PCIe, a smaller part
QWEN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]   # K -> N
MATMUL_MS = (1, 3, 8, 9, 16, 17, 32, 64, 128, 129, 505, 4096)
CUTS = {"ent_matmul_packed_fused": em.M_STREAM, "ent_matmul_packed": em.M_STREAM_PACKED,
        "ent_matmul": em.M_STREAM_PLANES, "int8_matmul": im.M_STREAM}


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "ref_tuning.json"))
    tuning.clear()
    ref_tuning.clear()
    yield
    tuning.clear()
    ref_tuning.clear()


def host_timer(fn, iters, warmup):
    """Seconds a call on the host clock (the CPU has no CUDA events)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _stream(m, k, n, sms=SMS):
    mb, kslice, _, _ = em.stream_plan(m, n, k, sms)
    return {"route": "stream", "mb": mb, "kslice": kslice}


# -- the reference's cases, on the port's families --------------------------

class TestHeuristics:
    def test_matmul_defaults_valid(self):
        for shape in [(256, 1024, 1024), (8, 128, 128), (96, 384, 192), (1, 64, 64)]:
            for fam in tuning.MATMUL_FAMILIES:
                cfg = tuning.get_block_config(fam, shape, sms=SMS)
                assert tuning._valid(fam, shape, cfg), (fam, shape, cfg)

    def test_decode_skinny_m(self):
        cfg = tuning.get_block_config("int8_matmul", (8, 4096, 4096), sms=SMS)
        assert cfg["route"] == "stream" and cfg["mb"] == 8

    def test_attention_defaults_valid(self):
        assert tuning._valid("paged_attention", (8, 2, 36),
                             tuning.get_block_config("paged_attention", (8, 2, 36), sms=SMS))
        assert tuning._valid("ring_decode", (8, 4, 4096),
                             tuning.get_block_config("ring_decode", (8, 4, 4096), sms=SMS))

    def test_unknown_family_raises(self):
        # the flash and SSD kernels fix their tiles at compile time: no knob
        for fam in ("conv3d", "flash_attention", "ssd_scan"):
            with pytest.raises(KeyError):
                tuning.get_block_config(fam, (1, 2, 3), sms=SMS)


class TestTableAndCache:
    def test_record_then_lookup_same_bucket(self):
        cfg = {"route": "tc", "kslice": 256}
        tuning.record("ent_matmul_packed_fused", (256, 1024, 1024), cfg, sms=SMS)
        assert tuning.get_block_config("ent_matmul_packed_fused", (256, 1024, 1024),
                                       sms=SMS) == cfg
        # bucketing: 200 rounds up to the 256 bucket, 1000 to 1024
        assert tuning.get_block_config("ent_matmul_packed_fused", (200, 1000, 1000),
                                       sms=SMS) == cfg
        # another card's SM count is another key: the heuristic
        assert tuning.get_block_config("ent_matmul_packed_fused", (256, 1024, 1024),
                                       sms=114) == {"route": "tc",
                                                    "kslice": em.tc_plan(256, 1024, 1024, 114)[0]}

    def test_persisted_and_reloaded(self):
        tuning.record("int8_matmul", (8, 512, 512), {"route": "stream", "mb": 4, "kslice": 64},
                      sms=SMS)
        with open(tuning.cache_path()) as f:
            data = json.load(f)
        assert "int8_matmul:8x512x512@132" in data
        tuning.reload()
        cfg = tuning.get_block_config("int8_matmul", (8, 512, 512), sms=SMS)
        assert cfg["kslice"] == 64 and cfg["mb"] == 4

    def test_overrides_win(self):
        cfg = tuning.get_block_config("ent_matmul_packed_fused", (8, 2048, 2048),
                                      {"kslice": 512, "mb": None}, sms=SMS)
        assert cfg["kslice"] == 512
        assert cfg["mb"] == _stream(8, 2048, 2048)["mb"]   # None override ignored


class TestCacheRobustness:
    """The cache survives concurrent writers and corrupt files: _save is
    write-temp + atomic rename, _load tolerates garbage."""

    def test_corrupt_cache_tolerated_and_overwritten(self):
        path = tuning.cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write('{"int8_matmul:8x512x512@132": {"kslice"')  # truncated
        tuning.reload()
        cfg = tuning.get_block_config("ent_matmul_packed_fused", (8, 2048, 2048), sms=SMS)
        assert dict(cfg) == _stream(8, 2048, 2048)  # heuristic fallback, no raise
        tuning.record("paged_attention", (8, 2, 36), {"pages": 4}, sms=SMS)
        with open(path) as f:
            assert json.load(f)["paged_attention:8x2x64@132"] == {"pages": 4}

    def test_non_dict_payload_tolerated(self):
        path = tuning.cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        for payload in ("[1, 2, 3]", '"scalar"', "null"):
            with open(path, "w") as f:
                f.write(payload)
            tuning.reload()
            assert tuning.get_block_config("paged_attention", (8, 2, 36), sms=SMS)

    def test_non_dict_entries_dropped(self):
        path = tuning.cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"paged_attention:8x2x64@132": "bogus",
                       "ring_decode:8x4x4096@132": {"rows": 256}}, f)
        tuning.reload()
        assert tuning.get_block_config("ring_decode", (8, 4, 4096), sms=SMS)["rows"] == 256
        # the bogus entry fell back to the heuristic instead of crashing
        assert tuning.get_block_config("paged_attention", (8, 2, 36), sms=SMS)["pages"] == \
            pa.split_plan(8, 2, 36, SMS)[0]

    def test_save_is_atomic_no_temp_left_behind(self):
        import glob
        tuning.record("paged_attention", (8, 2, 36), {"pages": 4}, sms=SMS)
        d = os.path.dirname(tuning.cache_path())
        assert not glob.glob(os.path.join(d, "*.tmp"))
        with open(tuning.cache_path()) as f:
            json.load(f)  # valid, complete JSON

    def test_read_only_cache_tolerated(self, tmp_path, monkeypatch):
        """A cache path that cannot be written (its directory is a file):
        the in-memory table still serves the process."""
        (tmp_path / "blocked").write_text("")
        monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "blocked" / "t.json"))
        tuning.reload()
        tuning.record("paged_attention", (8, 2, 36), {"pages": 8}, sms=SMS)
        assert tuning.get_block_config("paged_attention", (8, 2, 36), sms=SMS)["pages"] == 8


class TestAutotune:
    def test_picks_fastest_and_caches(self):
        calls = []

        def bench(cfg):
            calls.append(cfg["kslice"])
            if cfg["kslice"] != 512:
                time.sleep(0.002)   # 512 is the fastest: it returns at once

        cands = [{"route": "stream", "mb": 8, "kslice": ks} for ks in (256, 512, 1024)]
        best = tuning.autotune("ent_matmul_packed_fused", (8, 2048, 11008), bench, cands,
                               sms=SMS, iters=2, warmup=1, timer=host_timer)
        assert best["kslice"] == 512 and sorted(set(calls)) == [256, 512, 1024]
        assert tuning.get_block_config("ent_matmul_packed_fused", (8, 2048, 11008),
                                       sms=SMS)["kslice"] == 512

    def test_failing_candidates_disqualified(self):
        def bench(cfg):
            if cfg["pages"] == 64:
                raise RuntimeError("CUDA launch failed")

        best = tuning.autotune("paged_attention", (8, 2, 256), bench,
                               [{"pages": 64}, {"pages": 8}], sms=SMS, iters=1, warmup=0,
                               timer=host_timer)
        assert best == {"pages": 8}

    def test_all_failing_pins_the_heuristic(self):
        def bench(cfg):
            raise RuntimeError("no")

        best = tuning.autotune("ring_decode", (8, 4, 4096), bench, [{"rows": 64}], sms=SMS,
                               timer=host_timer)
        assert best == {"rows": pa.ring_split_plan(8, 4, 4096, SMS)[0]}

    def test_candidate_generators_valid(self):
        for fam in tuning.MATMUL_FAMILIES:
            for m, (k, n) in [(8, QWEN[2]), (32, QWEN[0]), (512, QWEN[3]), (3, (1000, 300))]:
                cands = tuning.matmul_candidates(fam, m, k, n, sms=SMS)
                assert {c["route"] for c in cands} == {"stream", "tc"}
                assert all(tuning._valid(fam, (m, k, n), c) for c in cands), (fam, m, k, n)
                assert dict(tuning.get_block_config(fam, (m, k, n), sms=SMS)) in cands
        for shape in [(8, 2, 36), (8, 2, 256), (1, 8, 3), (33, 8, 1700)]:
            cands = tuning.paged_attention_candidates(*shape, sms=SMS)
            assert all(tuning._valid("paged_attention", shape, c) for c in cands)
            assert cands[0] == dict(tuning.get_block_config("paged_attention", shape, sms=SMS))
        for shape in [(8, 4, 4096), (8, 4, 32), (1, 1, 100), (2, 8, 16384)]:
            cands = tuning.ring_decode_candidates(*shape, sms=SMS)
            assert all(tuning._valid("ring_decode", shape, c) for c in cands)
            assert cands[0] == dict(tuning.get_block_config("ring_decode", shape, sms=SMS))


# -- parity with the reference's module ------------------------------------

def _reload(mod):
    """Drop the table and read the file again (the reference has no
    ``reload``; the port's also drops its memo)."""
    if mod is tuning:
        tuning.reload()
    else:
        mod.clear()
        mod._LOADED = False


def test_bucket_and_fit_match_the_reference():
    for d in list(range(0, 70)) + [127, 128, 129, 1000, 2048, 11008, 54400]:
        assert tuning._bucket(d) == ref_tuning._bucket(d)
        for cap in (1, 3, 16, 64, 100, 128, 512, 4096):
            assert tuning._fit(d, cap) == ref_tuning._fit(d, cap), (d, cap)


def test_key_form_matches_the_reference():
    """``family:AxBxC`` as the reference writes it, then the card's SMs."""
    for shape in [(8, 2048, 11008), (200, 1000, 1000), (1, 1, 1)]:
        ref_key = ref_tuning._key("ent_matmul", shape)
        assert tuning._key("ent_matmul", shape, SMS) == f"{ref_key}@{SMS}"


def test_resolution_order_matches_the_reference():
    """Both modules: the in-memory table first, then the file, then the
    heuristic; a clear() is not undone by the file."""
    cases = ((ref_tuning, "int8_matmul", (128, 512, 512),
              {"block_m": 64, "block_n": 128, "block_k": 128}, {}),
             (tuning, "int8_matmul", (128, 512, 512), {"route": "tc", "kslice": 256},
              dict(sms=SMS)))
    for mod, fam, shape, cfg, kw in cases:
        heur = dict(mod.get_block_config(fam, shape, **kw))
        mod.record(fam, shape, cfg, persist=False, **kw)
        assert dict(mod.get_block_config(fam, shape, **kw)) == {**heur, **cfg}   # memory
        assert not os.path.exists(mod.cache_path())
        mod.record(fam, shape, cfg, **kw)
        mod.clear()
        assert dict(mod.get_block_config(fam, shape, **kw)) == heur   # cleared: not the file
        _reload(mod)
        assert dict(mod.get_block_config(fam, shape, **kw)) == {**heur, **cfg}   # the file
        os.unlink(mod.cache_path())
        _reload(mod)
        assert dict(mod.get_block_config(fam, shape, **kw)) == heur   # no file


def test_fake_bench_autotune_matches_the_reference():
    """The same fake bench (the third candidate fast) picks the same
    winner in both modules and persists one entry under the shared key
    form."""
    def bench_of(knob, fast):
        def bench(cfg):
            if cfg[knob] != fast:
                time.sleep(0.002)
        return bench

    ref_cands = [{"block_m": 8, "block_n": 128, "block_k": bk} for bk in (128, 256, 512)]
    ref_best = ref_tuning.autotune("int8_matmul", (8, 2048, 2048), bench_of("block_k", 512),
                                   ref_cands, iters=2, warmup=1)
    cands = [{"route": "stream", "mb": 8, "kslice": ks} for ks in (128, 256, 512)]
    best = tuning.autotune("int8_matmul", (8, 2048, 2048), bench_of("kslice", 512), cands,
                           sms=SMS, iters=2, warmup=1, timer=host_timer)
    assert ref_cands.index(ref_best) == cands.index(best) == 2
    with open(ref_tuning.cache_path()) as f:
        ref_file = json.load(f)
    with open(tuning.cache_path()) as f:
        port_file = json.load(f)
    assert list(ref_file) == ["int8_matmul:8x2048x2048"] and ref_file[list(ref_file)[0]] == ref_best
    assert port_file == {f"int8_matmul:8x2048x2048@{SMS}": best}


@pytest.mark.parametrize("payload", ['{"x": {"a"', "[1, 2, 3]", '"scalar"', "null", "",
                                     '{"k": "bogus"}'])
def test_corrupt_cache_behaviour_matches_the_reference(payload):
    """Each garbage file leaves both modules on their heuristics, with no
    raise, and the next record rewrites it as valid JSON."""
    for mod, fam, shape, cfg, kw in ((ref_tuning, "ent_matmul", (8, 128, 128), {"block_m": 8},
                                      {}),
                                     (tuning, "paged_attention", (8, 2, 36), {"pages": 4},
                                      dict(sms=SMS))):
        path = mod.cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(payload)
        _reload(mod)
        assert dict(mod.get_block_config(fam, shape, **kw)) == dict(mod._heuristic(fam, shape,
                                                                                   **kw))
        mod.record(fam, shape, cfg, **kw)
        with open(path) as f:
            assert list(json.load(f).values()) == [cfg]


# -- the heuristics are the wrappers' plans ---------------------------------

@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("family", tuning.MATMUL_FAMILIES)
def test_matmul_heuristic_is_the_wrappers_plan(family, sms):
    """route_of by the family's own cut, then stream_plan or tc_plan (64-row
    blocks for kernel 5), over a grid of shapes."""
    bm = em.TC_BM_PLANES if family == "ent_matmul" else em.TC_BM
    for k, n in QWEN + [(1000, 300), (16, 7), (20000, 64)]:
        for m in MATMUL_MS:
            cfg = tuning.get_block_config(family, (m, k, n), sms=sms)
            assert cfg["route"] == em.route_of(m, CUTS[family])
            for route in ("stream", "tc"):
                got = tuning.get_block_config(family, (m, k, n), sms=sms, route=route)
                want = (_stream(m, k, n, sms) if route == "stream"
                        else {"route": "tc", "kslice": em.tc_plan(m, n, k, sms, bm)[0]})
                assert dict(got) == want, (m, k, n, route)
                assert tuning._valid(family, (m, k, n), got)


@pytest.mark.parametrize("sms", CARDS)
def test_attention_heuristics_are_the_wrappers_plans(sms):
    for b in (1, 4, 8, 16, 33):
        for hkv in (1, 2, 4, 8):
            for pps in (1, 3, 16, 36, 256, 1700):
                cfg = tuning.get_block_config("paged_attention", (b, hkv, pps), sms=sms)
                assert cfg == {"pages": pa.split_plan(b, hkv, pps, sms)[0]}
            for w in (32, 100, 4096, 8192):
                cfg = tuning.get_block_config("ring_decode", (b, hkv, w), sms=sms)
                assert cfg == {"rows": pa.ring_split_plan(b, hkv, w, sms)[0]}


def test_the_cut_is_read_at_call_time(monkeypatch):
    """chip_smoke.py moves a cut to profile the other route: the memo
    must not keep the old one."""
    assert tuning.get_block_config("int8_matmul", (12, 2048, 2048), sms=SMS)["route"] == "stream"
    monkeypatch.setattr(im, "M_STREAM", 8)
    assert tuning.get_block_config("int8_matmul", (12, 2048, 2048), sms=SMS)["route"] == "tc"


@pytest.mark.parametrize("bad", [{"route": "stream", "mb": 6, "kslice": 256},
                                 {"route": "stream", "mb": 8, "kslice": 100},
                                 {"route": "stream", "mb": 8, "kslice": 4096},
                                 {"route": "tc", "kslice": 192},
                                 {"route": "tile", "kslice": 256},
                                 {"route": "stream", "mb": 8.0, "kslice": 256},
                                 {"route": "tc", "mb": 8, "kslice": 256},
                                 {"route": "stream", "mb": 8, "kslice": 256, "pages": 2},
                                 {"kslice": -16}])
def test_invalid_cached_matmul_entry_falls_back(bad):
    shape = (8, 2048, 11008)
    tuning.record("ent_matmul_packed_fused", shape, bad, sms=SMS)
    assert dict(tuning.get_block_config("ent_matmul_packed_fused", shape, sms=SMS)) == \
        _stream(*shape)


@pytest.mark.parametrize("family,shape,bad", [
    ("paged_attention", (8, 2, 36), {"pages": 0}),
    ("paged_attention", (8, 2, 36), {"pages": pa.MAX_RUN_PAGES + 1}),
    ("paged_attention", (8, 2, 36), {"pages": "4"}),
    ("ring_decode", (8, 4, 4096), {"rows": 48}),
    ("ring_decode", (8, 4, 4096), {"rows": pa.MAX_RING_ROWS + pa.STAGE_ROWS}),
    ("ring_decode", (8, 4, 4096), {"pages": 2})])
def test_invalid_cached_attention_entry_falls_back(family, shape, bad):
    heur = dict(tuning._heuristic(family, shape, SMS))
    tuning.record(family, shape, bad, sms=SMS)
    assert dict(tuning.get_block_config(family, shape, sms=SMS)) == heur


def test_a_partial_entry_fills_in_from_the_heuristic():
    """An entry of one knob keeps the other knobs of its route's plan; an
    entry for the other route takes that route's plan, and a forced
    route ignores an entry of the other route."""
    shape = (8, 2048, 11008)
    tuning.record("ent_matmul_packed_fused", shape, {"kslice": 512}, sms=SMS)
    assert dict(tuning.get_block_config("ent_matmul_packed_fused", shape, sms=SMS)) == \
        {**_stream(*shape), "kslice": 512}
    tuning.record("ent_matmul_packed_fused", shape, {"route": "tc"}, sms=SMS)
    assert dict(tuning.get_block_config("ent_matmul_packed_fused", shape, sms=SMS)) == \
        {"route": "tc", "kslice": em.tc_plan(8, 11008, 2048, SMS)[0]}
    assert dict(tuning.get_block_config("ent_matmul_packed_fused", shape, sms=SMS,
                                        route="stream")) == _stream(*shape)


def test_memo_is_dropped_by_record_clear_and_reload():
    fam, shape = "paged_attention", (8, 2, 36)
    first = tuning.get_block_config(fam, shape, sms=SMS)
    assert tuning.get_block_config(fam, shape, sms=SMS) is first   # memoised, shared
    with pytest.raises(TypeError):
        first["pages"] = 9   # read-only
    tuning.record(fam, shape, {"pages": 9}, sms=SMS)
    assert tuning.get_block_config(fam, shape, sms=SMS)["pages"] == 9
    tuning.clear()
    assert tuning.get_block_config(fam, shape, sms=SMS) == first
    tuning.record(fam, shape, {"pages": 6}, sms=SMS)
    tuning.clear()
    tuning.reload()
    assert tuning.get_block_config(fam, shape, sms=SMS)["pages"] == 6
    assert not tuning.empty()


# -- the wrappers read the table on card tensors, never on CPU tensors ------

class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((fname, args))
            return 0
        return fn


META = torch.device("meta")


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(em._build, "entry", rec.entry)
    monkeypatch.setattr(em._build, "stream_of", lambda t: 0)
    monkeypatch.setitem(em._build._sms, META, SMS)
    monkeypatch.setattr(em._build, "_workspaces", {})
    return rec


def _fused_operands(m, k, n, device=META):
    return (torch.empty((m, k), dtype=torch.bfloat16, device=device),
            torch.empty((2, k, n), dtype=torch.int8, device=device),
            torch.empty((m, 1), dtype=torch.float32, device=device),
            torch.empty((1, n), dtype=torch.float32, device=device))


def test_matmul_wrappers_launch_the_tables_plan(recorder):
    """A recorded plan moves kernel 1's route and K slice, and kernel 6's
    stream rows a block, at their shapes' buckets only."""
    tuning.record("ent_matmul_packed_fused", (8, 2048, 11008), {"route": "tc", "kslice": 512},
                  sms=SMS, persist=False)
    tuning.record("int8_matmul", (8, 2048, 2048), {"route": "stream", "mb": 4, "kslice": 256},
                  sms=SMS, persist=False)
    em.ent_matmul_packed_fused(*_fused_operands(8, 2048, 11008), torch.float32)
    em.ent_matmul_packed_fused(*_fused_operands(8, 2048, 2048), torch.float32)   # no entry
    x8 = torch.empty((8, 2048), dtype=torch.int8, device=META)
    w8 = torch.empty((2048, 2048), dtype=torch.int8, device=META)
    sx, sw = torch.empty((8, 1), device=META), torch.empty((1, 2048), device=META)
    im.int8_matmul(x8, w8, sx, sw, torch.float32)
    (f1, a1), (f2, a2), (f6, a6) = recorder.calls
    assert f1 == "ent_matmul_packed_fused_tc" and a1[11:16] == (8, 11008, 2048, 512, 4)
    plan = em.stream_plan(8, 2048, 2048, SMS)
    assert f2 == "ent_matmul_packed_fused_stream" and a2[11:17] == (8, 2048, 2048, *plan[:3])
    assert f6 == "int8_matmul_stream" and a6[10:16] == (8, 2048, 2048, 4, 256, 8)
    assert a6[9] >= 2048 // em.STREAM_BN * 2   # tickets for two 4-row chunks a strip


def test_launch_helpers_take_a_plan(recorder):
    """chip_smoke.py's tuning bench: the private launch helpers take the
    plan they are given (overrides win over the table)."""
    tuning.record("ent_matmul_packed_fused", (8, 2048, 11008), {"kslice": 512}, sms=SMS,
                  persist=False)
    em._launch_fused(*_fused_operands(8, 2048, 11008), torch.float32, "stream",
                     plan={"route": "stream", "mb": 8, "kslice": 2048})
    em._launch_fused(*_fused_operands(8, 2048, 11008), torch.float32, "stream")
    (_, a), (_, b) = recorder.calls
    assert a[14:17] == (8, 2048, 1) and a[7:11] == (None, 0, None, 0)   # one split: no workspace
    assert b[14:17] == (8, 512, 4)


def test_paged_wrappers_launch_the_tables_plan(recorder, monkeypatch):
    monkeypatch.setattr(pa._build, "entry", recorder.entry)
    b, hq, hkv, d, page, pps = 8, 16, 2, 128, 16, 36
    q = torch.empty((b, hq, 1, d), dtype=torch.bfloat16, device=META)
    pool = torch.empty((b * pps + 1, page, hkv, d), dtype=torch.bfloat16, device=META)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=META)  # noqa: E731
    tuning.record("paged_attention", (b, hkv, pps), {"pages": 8}, sms=SMS, persist=False)
    pa.paged_attention_kernel(q, pool, pool, i32(b, pps), i32(b), i32(b), page_size=page)
    pa.paged_attention_kernel(q, pool, pool, i32(b, pps), i32(b), i32(b), page_size=page,
                              plan={"pages": 36})
    ring = torch.empty((b, 4096, hkv, d), dtype=torch.bfloat16, device=META)
    tuning.record("ring_decode", (b, hkv, 4096), {"rows": 1024}, sms=SMS, persist=False)
    pa.ring_decode_kernel(q, ring, ring, i32(b), i32(b), window=4096)
    (f1, a1), (f2, a2), (f3, a3) = recorder.calls
    assert f1 == "paged_attention" and a1[21:23] == (8, 5)
    assert f2 == "paged_attention" and a2[21:23] == (36, 1) and a2[9] is None
    assert f3 == "ring_decode_attention" and a3[19:21] == (1024, 4)


def test_cpu_tensors_never_read_the_table(monkeypatch):
    """On CPU tensors every wrapper takes its plain version without asking
    the table (nor the SM count)."""
    def boom(*a, **k):
        raise AssertionError("the table was read")

    monkeypatch.setattr(tuning, "get_block_config", boom)
    monkeypatch.setattr(tuning, "empty", boom)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 64), generator=g)
    w8 = torch.randint(-127, 128, (64, 32), generator=g, dtype=torch.int8)
    from repro_torch.core.multiplier import ent_packed_planes
    packed = ent_packed_planes(w8).contiguous()
    sx, sw = torch.ones((8, 1)), torch.ones((1, 32))
    out = em.ent_matmul_packed_fused(x, packed, sx, sw, torch.int32)
    assert out.shape == (8, 32)
    xq = torch.randint(-127, 128, (8, 64), generator=g, dtype=torch.int8)
    assert torch.equal(im.int8_matmul(xq, w8, sx, sw, torch.int32),
                       em.ent_matmul_packed(xq, packed, sx, sw, torch.int32))
    q = torch.randn((2, 4, 1, 64), generator=g)
    pool = torch.randn((5, 4, 2, 64), generator=g)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 3], dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    assert pa.paged_attention_kernel(q, pool, pool, table, pos, start, page_size=4).shape == \
        (2, 4, 1, 64)
    ring = torch.randn((2, 8, 2, 64), generator=g)
    assert pa.ring_decode_kernel(q, ring, ring, pos, start, window=8).shape == (2, 4, 1, 64)


def test_the_port_imports_no_jax():
    """The module stands alone: no jax, nothing of the reference."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(tuning))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in ("jax", "repro")], names
