"""The port's span recorder (``repro_torch/tracing.py``) on the CPU.

* Off: ``span`` hands back one shared null context, reads no clock and
  keeps nothing; ``close`` records nothing.
* On: parents come from the span open on the same thread (a span opened
  on a second thread does not nest under the first thread's), and
  threads switching every microsecond lose no span; ``close``
  records a parentless span only while the recorder is on, and a span
  still open when the recorder stops is dropped.
* The scheduler's spans on reduced qwen2.5-3b (chunked paged admission
  and dense atomic admission): ``sched.decode`` inside ``sched.tick``,
  one ``req.queued`` a request, each admitted once; the token streams
  with the recorder on equal those with it off, bit for bit.
* The train step's spans, single-device and sharded on a (1, 1) mesh:
  ``train.backward`` once a microbatch and ``train.adamw`` once, inside
  ``train.step``; the trained parameters and moments with the recorder
  on equal those with it off, bit for bit.
"""

import contextlib
import sys
import threading
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_worker as dw  # noqa: E402
from repro_torch import sharding, tracing  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import OptimConfig, TrainConfig  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.scheduler import PipelinedScheduler  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SERVE_CFG = reduced_config(get_config("qwen2.5-3b"))


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _no_clock():
    raise AssertionError("the recorder read the clock while off")


@contextlib.contextmanager
def _clockless(monkeypatch):
    """The recorder's clock raises inside: code run there reads none."""
    with monkeypatch.context() as mp:
        mp.setattr(tracing, "time", SimpleNamespace(time_ns=_no_clock))
        yield


def _off_calls(n):
    got = set()
    for _ in range(n):
        ctx = tracing.span("sched.decode", rows=3)
        with ctx:
            got.add(id(ctx))
        got.add(id(tracing.span("train.step")))
        tracing.close("req.queued", 5, uid=1)
    return got


def _kept_by(n):
    """(bytes still held after ``_off_calls(n)``, the ids it saw)."""
    before = tracemalloc.get_traced_memory()[0]
    ids = _off_calls(n)
    return tracemalloc.get_traced_memory()[0] - before, ids


def test_off_is_one_shared_object_no_clock_nothing_kept(monkeypatch):
    _off_calls(10)                      # warm: first calls may intern names
    tracemalloc.start()
    try:
        with _clockless(monkeypatch):
            few, _ = _kept_by(10)
            many, ids = _kept_by(1000)
    finally:
        tracemalloc.stop()
    assert len(ids) == 1 and ids == {id(tracing.span("x"))}
    assert many == few, "calls with the recorder off kept memory"
    assert tracing.disable() == []


def test_parents_nest_per_thread():
    tracing.enable()
    inner_started, release = threading.Event(), threading.Event()

    def other():
        with tracing.span("c"):
            with tracing.span("d", k=2):
                inner_started.set()
                release.wait(10)

    with tracing.span("a"):
        with tracing.span("b", k=1):
            t = threading.Thread(target=other)
            t.start()
            assert inner_started.wait(10)
        release.set()
        t.join(10)
    assert not t.is_alive()
    spans = {s.name: s for s in tracing.disable()}
    assert set(spans) == {"a", "b", "c", "d"}
    a, b, c, d = (spans[k] for k in "abcd")
    assert a.parent_id is None and b.parent_id == a.id and b.attrs == {"k": 1}
    assert c.parent_id is None, "a span on another thread nested under this thread's"
    assert d.parent_id == c.id and d.attrs == {"k": 2}
    assert a.thread_id == b.thread_id != c.thread_id == d.thread_id
    assert len({s.id for s in spans.values()}) == 4
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert a.start_ns <= b.start_ns and b.end_ns <= a.end_ns


def test_threads_lose_no_span():
    """More threads than cores, switching every microsecond: every span is
    kept once, with a unique id and a parent from its own thread."""
    old = sys.getswitchinterval()
    n_threads, n_spans = 16, 200

    def work():
        for i in range(n_spans):
            with tracing.span("outer"):
                with tracing.span("inner", i=i):
                    pass

    tracing.enable()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.disable()
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s.thread_id for s in spans if s.name == "outer"}
    assert all(outer[s.parent_id] == s.thread_id for s in spans if s.name == "inner")


def test_close_records_only_while_on():
    tracing.close("req.queued", time.time_ns(), uid=1)
    tracing.enable()
    start = time.time_ns()
    with tracing.span("sched.tick"):
        tracing.close("req.queued", start, uid=7)
        with tracing.span("late"):
            kept = tracing.disable()     # stops while "late" is open
        tracing.close("req.queued", start, uid=8)
    assert [(s.name, s.attrs, s.parent_id, s.start_ns) for s in kept] == [
        ("req.queued", {"uid": 7}, None, start)]
    assert kept[0].end_ns >= start
    assert tracing.disable() == []


# .. the scheduler ..

def _requests(n, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, SERVE_CFG.vocab_size, 6).tolist()
    return [(prefix + rng.integers(1, SERVE_CFG.vocab_size, int(rng.integers(2, 8))).tolist(),
             6, (0.0, 0.9)[i % 2]) for i in range(n)]


def _served(engine_kw, n):
    model, params = port_serve.build(SERVE_CFG, seed=0, device="cpu")
    sched = PipelinedScheduler(ServeEngine(model, params, **engine_kw), pipeline_depth=1,
                               prefill_chunk=4)
    uids = [sched.submit(t, max_new_tokens=m, temperature=temp) for t, m, temp in
            _requests(n)]
    return uids, sched.run()


@pytest.mark.parametrize("engine_kw", [dict(slots=2, max_len=64, seed=5),
                                       dict(slots=2, max_len=48, seed=5, cache_kind="dense")],
                         ids=["paged-chunked", "dense-atomic"])
def test_scheduler_spans_and_streams(engine_kw, monkeypatch):
    with _clockless(monkeypatch):
        uids, off = _served(engine_kw, 5)
    tracing.enable()
    uids_on, on = _served(engine_kw, 5)
    spans = tracing.disable()
    assert uids_on == uids and on == off
    ticks = {s.id for s in spans if s.name == "sched.tick"}
    decodes = [s for s in spans if s.name == "sched.decode"]
    assert ticks and decodes
    assert all(s.parent_id is None for s in spans if s.name == "sched.tick")
    assert all(s.parent_id in ticks and 1 <= s.attrs["rows"] <= 2 for s in decodes)
    queued = [s for s in spans if s.name == "req.queued"]
    assert sorted(s.attrs["uid"] for s in queued) == sorted(uids)
    assert all(s.parent_id is None and s.start_ns <= s.end_ns for s in queued)
    assert {s.name for s in spans} == {"sched.tick", "sched.decode", "req.queued"}


# .. the train step ..

ROWS, SEQ = 4, 16


@pytest.fixture
def world1(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


def _stepped(cfg, tcfg, batch, mesh):
    params = dw.init_params(cfg)
    if mesh is None:
        step = make_train_step(Model(cfg, device="cpu"), OptimConfig(), tcfg)
    else:
        specs = sharding.params_shardings(params, mesh)
        params = sharding.local_shard_tree(params, specs, mesh)
        step = make_train_step(Model(cfg, device="cpu", dist=(mesh, "data")), OptimConfig(),
                               tcfg, data_axes="data", grad_shardings=specs)
    opt = init_opt_state(tcfg, params)
    params, opt, m = step(params, opt, batch)
    return [params, opt["adam"]["m"], opt["adam"]["v"]], m


def _check_step_spans(spans, n_micro, n_leaves):
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 1 and steps[0].parent_id is None
    back = [s for s in spans if s.name == "train.backward"]
    assert [s.attrs["microbatch"] for s in back] == list(range(n_micro))
    adamw = [s for s in spans if s.name == "train.adamw"]
    assert len(adamw) == 1 and adamw[0].attrs == {"leaves": n_leaves}
    for s in back + adamw:
        assert s.parent_id == steps[0].id
        assert steps[0].start_ns <= s.start_ns <= s.end_ns <= steps[0].end_ns
    assert back[-1].end_ns <= adamw[0].start_ns


def _step_on_and_off(mesh, monkeypatch):
    cfg = dw.step_config("qwen2.5-3b")
    tcfg = TrainConfig(seq_len=SEQ, global_batch=ROWS, microbatch=2)
    batch = {k: torch.from_numpy(v) for k, v in dw.token_batch(cfg.vocab_size, ROWS, SEQ).items()}
    with _clockless(monkeypatch):
        off, m_off = _stepped(cfg, tcfg, batch, mesh)
    tracing.enable()
    on, m_on = _stepped(cfg, tcfg, batch, mesh)
    spans = tracing.disable()
    assert torch.equal(m_on["loss"], m_off["loss"])
    for a, b in zip(off, on):
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)
    _check_step_spans(spans, 2, len(leaves(on[0])))


def test_train_step_spans_and_params(monkeypatch):
    _step_on_and_off(None, monkeypatch)


def test_sharded_train_step_spans_and_params(world1, monkeypatch):
    _step_on_and_off(world1, monkeypatch)
