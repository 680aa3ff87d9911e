"""The port's HTTP/SSE front end (``runtime/server.py``) over its scheduler,
on the CPU: ``/healthz`` states, 404 / 400 / 413 / 429 / 503, SSE stream
≡ its final event (and the scheduler's result), non-streaming
completions, the ``/metrics`` document and its leak probe, a client
disconnect cancelling and freeing its request, an injected socket-write
fault doing the same, a quarantined request's structured 500, and the
CLI's ``--http --http-smoke`` with and without a fault plan, and the
reference's slow-client test (a hung write overflowing the bounded
per-stream queue).  Every client call has a timeout; the server binds an
ephemeral port."""

import functools
import http.client
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.runtime.faults import Fault, FaultPlan  # noqa: E402
from repro_torch.runtime.scheduler import PipelinedScheduler  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402
from repro_torch.runtime.server import ServingServer  # noqa: E402

CFG = reduced_config(get_config("qwen2.5-3b"))


@functools.lru_cache(maxsize=None)
def _port():
    return port_serve.build(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def served():
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=512, seed=7)
    sched = PipelinedScheduler(eng, pipeline_depth=1, prefill_chunk=8)
    srv = ServingServer(sched)
    host, port = srv.start()
    yield eng, sched, host, port
    srv.stop()
    eng.check_leaks()


def _conn(served, timeout=120):
    return http.client.HTTPConnection(served[2], served[3], timeout=timeout)


def _post(served, doc, timeout=120):
    c = _conn(served, timeout)
    c.request("POST", "/v1/completions", json.dumps(doc), {"Content-Type": "application/json"})
    return c, c.getresponse()


def _get_json(served, path):
    c = _conn(served, 60)
    c.request("GET", path)
    r = c.getresponse()
    body = json.loads(r.read())
    c.close()
    return r.status, body


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n).tolist()


def _wait_cancelled(served, before):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        _, m = _get_json(served, "/metrics")
        if m["requests"]["cancelled"] > before and m["queue"]["active_slots"] == 0:
            break
        time.sleep(0.05)
    return m


def test_healthz_and_unknown_route(served):
    assert _get_json(served, "/healthz") == (200, {"ok": True, "state": "ready"})
    assert _get_json(served, "/nope")[0] == 404


def test_bad_body_400(served):
    for doc in ({}, {"tokens": []}, {"tokens": "abc"}, {"tokens": [1.5]},
                {"tokens": [1, 2], "max_new_tokens": 10_000}):
        c, r = _post(served, doc)
        assert r.status == 400, doc
        r.read()
        c.close()


def test_sse_stream_matches_final_event(served):
    eng, sched, *_ = served
    c, r = _post(served, {"tokens": _prompt(12), "max_new_tokens": 6})
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    events = [json.loads(ln[6:]) for ln in r.read().decode().splitlines()
              if ln.startswith("data: ")]
    c.close()
    assert events[-1]["done"] is True
    streamed = [e["token"] for e in events[:-1]]
    assert [e["index"] for e in events[:-1]] == list(range(len(streamed)))
    assert streamed == events[-1]["tokens"] and len(streamed) == 6
    assert sched.results[events[-1]["uid"]] == streamed


def test_non_streaming_collect(served):
    c, r = _post(served, {"tokens": _prompt(10, seed=1), "max_new_tokens": 4,
                          "stream": False, "temperature": 0.8})
    assert r.status == 200
    body = json.loads(r.read())
    c.close()
    assert len(body["tokens"]) == 4 and all(isinstance(t, int) for t in body["tokens"])


def test_metrics_shape_and_leak_probe(served):
    for seed in (2, 3):   # at least two finished requests, whatever ran before
        c, r = _post(served, {"tokens": _prompt(6, seed=seed), "max_new_tokens": 3,
                              "stream": False})
        assert r.status == 200
        r.read()
        c.close()
    status, m = _get_json(served, "/metrics")
    assert status == 200 and m["leaks_clean"] is True
    assert m["requests"]["finished"] >= 2 and m["ttft"]["count"] >= 2
    assert m["inter_token"]["p99_us"] >= m["inter_token"]["p50_us"]
    assert "pages" in m and "prefix_cache" in m
    assert {"faults", "queue", "tokens", "state", "capacity"} <= set(m)


def test_disconnect_cancels_and_frees(served):
    """Closing the socket mid-stream cancels the request through the
    scheduler: slot and pages return and the leak probe stays clean."""
    eng, sched, *_ = served
    before = sched.metrics.cancelled_total
    c, r = _post(served, {"tokens": _prompt(8, seed=4), "max_new_tokens": 480})
    assert r.status == 200
    r.read(40)
    r.close()
    c.close()
    m = _wait_cancelled(served, before)
    assert m["requests"]["cancelled"] == before + 1
    assert m["leaks_clean"] is True and m["queue"]["active_slots"] == 0


def test_oversized_body_413(served):
    c = _conn(served)
    c.putrequest("POST", "/v1/completions")
    c.putheader("Content-Type", "application/json")
    c.putheader("Content-Length", str((8 << 20) + 1))
    c.endheaders()
    r = c.getresponse()
    assert r.status == 413
    r.read()
    c.close()


def test_draining_503_and_429(served):
    eng, sched, *_ = served
    sched.drain()
    try:
        assert _get_json(served, "/healthz") == (503, {"ok": False, "state": "draining"})
        c, r = _post(served, {"tokens": _prompt(6, seed=5), "max_new_tokens": 2})
        assert r.status == 429 and json.loads(r.read())["error"] == "draining"
        c.close()
    finally:
        sched.undrain()
    assert _get_json(served, "/healthz") == (200, {"ok": True, "state": "ready"})


def test_queue_full_429():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=64, seed=7)
    sched = PipelinedScheduler(eng, max_queue=1, prefill_chunk=8)
    srv = ServingServer(sched)
    assert srv.state == "starting"
    sched.set_capacity(0)      # nothing admits: the one queued request stays queued
    uid = sched.submit(_prompt(4, seed=6), max_new_tokens=2)
    host, port = srv.start()
    try:
        assert _get_json((eng, sched, host, port), "/healthz")[1]["state"] == "ready"
        c = http.client.HTTPConnection(host, port, timeout=60)
        c.request("POST", "/v1/completions", json.dumps({"tokens": [1, 2, 3]}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 429 and json.loads(r.read())["error"] == "queue full"
        c.close()
        sched.set_capacity(1)
        deadline = time.monotonic() + 60
        while sched.status(uid) != "done" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sched.status(uid) == "done"
    finally:
        srv.stop()
    eng.check_leaks()
    assert sched.metrics.shed_counts == {"queue_full": 1}


def test_injected_write_fault_cancels_stream(served):
    eng, sched, *_ = served
    before = sched.metrics.cancelled_total
    with FaultPlan([Fault("server.write", at=3)]) as plan:
        c, r = _post(served, {"tokens": _prompt(8, seed=8), "max_new_tokens": 480})
        assert r.status == 200
        try:
            r.read()
        except (http.client.HTTPException, ConnectionError, OSError):
            pass
        c.close()
        m = _wait_cancelled(served, before)
    assert plan.fired and plan.fired[0].site == "server.write"
    assert m["requests"]["cancelled"] == before + 1 and m["leaks_clean"] is True


def test_serving_continues_after_errors(served):
    c, r = _post(served, {"tokens": _prompt(6, seed=9), "max_new_tokens": 3, "stream": False})
    assert r.status == 200 and len(json.loads(r.read())["tokens"]) == 3
    c.close()


def test_slow_client_bounded_queue_disconnects():
    """The reference's slow-client test (``tests/test_server.py:279``): a
    client that stops draining its stream (every socket write hangs 0.2 s)
    backs tokens up into the bounded per-stream queue; its overflow is
    treated as a dead client: cancel and abort, no unbounded buffering, no
    leak."""
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=512, seed=7)
    sched = PipelinedScheduler(eng, prefill_chunk=8)
    srv = ServingServer(sched, max_stream_queue=1)
    host, port = srv.start()
    plan = FaultPlan([Fault("server.write", times=9999, kind="hang", seconds=0.2)])
    try:
        with plan:
            c = http.client.HTTPConnection(host, port, timeout=600)
            c.request("POST", "/v1/completions",
                      json.dumps({"tokens": _prompt(8, seed=8), "max_new_tokens": 400}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            deadline = time.monotonic() + 60
            while sched.metrics.cancelled_total < 1 and time.monotonic() < deadline:
                time.sleep(0.2)
            try:
                r.read()
            except (http.client.HTTPException, ConnectionError, OSError):
                pass
            c.close()
    finally:
        srv.stop()
    assert sched.metrics.cancelled_total == 1
    assert plan.fired and plan.fired[0].kind == "hang"
    eng.check_leaks()


@pytest.mark.parametrize("stream", [False, True])
def test_quarantined_request_reports_structured_error(stream):
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=7)
    sched = PipelinedScheduler(eng, prefill_chunk=8, max_retries=1)
    srv = ServingServer(sched)
    host, port = srv.start()
    try:
        with FaultPlan([Fault("prefill.dispatch", uid=0, times=99)]):
            c = http.client.HTTPConnection(host, port, timeout=120)
            c.request("POST", "/v1/completions",
                      json.dumps({"tokens": _prompt(8, seed=10), "max_new_tokens": 4,
                                  "stream": stream}), {"Content-Type": "application/json"})
            r = c.getresponse()
            if stream:
                assert r.status == 200
                events = [json.loads(ln[6:]) for ln in r.read().decode().splitlines()
                          if ln.startswith("data: ")]
                body = events[-1]
                assert body["error"] == "failed" and body["uid"] == 0
            else:
                assert r.status == 500
                body = json.loads(r.read())
                assert body["error"] == "request failed"
            c.close()
            assert body["detail"]["site"] == "prefill.dispatch"
            assert body["detail"]["error"] == "InjectedFault"
            c = http.client.HTTPConnection(host, port, timeout=120)
            c.request("POST", "/v1/completions",
                      json.dumps({"tokens": _prompt(6, seed=11), "max_new_tokens": 3,
                                  "stream": False}), {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200 and len(json.loads(r.read())["tokens"]) == 3
            c.close()
    finally:
        srv.stop()
    eng.check_leaks()
    assert sched.errors[0]["uid"] == 0


@pytest.mark.parametrize("plan", ["", "ci-chaos"])
def test_cli_http_smoke(plan, capsys):
    """``--http --http-smoke --device cpu`` on the smoke config: the SSE
    stream equals its final event, /healthz 200, /metrics leak-clean with
    one finished request; under a plan every fired fault is counted and
    none quarantined."""
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--quantize", "--http", "--http-smoke",
            "--device", "cpu", "--steps", "12"]
    if plan:
        argv += ["--fault-plan", plan]
    out = port_serve.main(argv)
    assert len(out["tokens"]) == 12
    assert out["metrics"]["leaks_clean"] and out["metrics"]["requests"]["finished"] == 1
    if plan:
        assert out["fired"] and out["metrics"]["faults"]["quarantined"] == 0
        assert out["metrics"]["faults"]["total"] == len(out["fired"])
    assert "http smoke: 12 tokens streamed" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--engine", "--device", "cpu",
                         "--fault-plan", "ci-chaos"])
