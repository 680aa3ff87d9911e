"""Stdlib-asyncio HTTP front end: SSE token streaming over the scheduler
(port of ``repro/runtime/server.py``).

:class:`ServingServer` binds a :class:`~repro_torch.runtime.scheduler.
PipelinedScheduler` to a plain HTTP/1.1 endpoint — no framework, no
dependency beyond ``asyncio``:

* ``POST /v1/completions`` — body ``{"tokens": [int, ...],
  "max_new_tokens": 32, "temperature": 0.0, "priority": 0,
  "deadline": null, "stream": true}``.  Streams each sampled token as a
  Server-Sent Event the moment the engine emits it::

      data: {"index": 0, "token": 1234}

      data: {"done": true, "uid": 7, "tokens": [1234, ...]}

  ``"stream": false`` collects the whole completion and answers one
  JSON document instead.  A full queue answers **429** (the scheduler
  sheds, it never stalls); a malformed/oversized request answers 400.
* ``GET /metrics`` — the scheduler's JSON metrics snapshot (TTFT /
  inter-token p50/p99, queue depth, shed counts, fault/retry/degrade
  counters, page + prefix-cache + spec-decode counters) plus an
  allocator ``leaks_clean`` probe.
* ``GET /healthz`` — READINESS, not just liveness: answers
  ``{"ok": bool, "state": ...}`` where state is "starting" (engine
  thread not yet spinning), "ready", "degraded" (serving, but the
  scheduler's DegradePolicy is active — still 200: degraded capacity
  is capacity), or "draining" (elastic drain: 503 so load balancers
  stop routing here while in-flight streams finish).

Failure semantics: a request the fault-tolerant scheduler QUARANTINES
closes its stream with a ``(None, True)`` sentinel — the SSE stream
emits ``data: {"error": "failed", ...}`` (with the structured record
from ``scheduler.errors``) and a non-streaming request answers 500.
Per-stream token queues are BOUNDED (``max_stream_queue``): a client
too slow to drain its own completion has its request cancelled and its
socket aborted instead of buffering the stream unboundedly.  Socket
writes pass the ``"server.write"`` fault-injection site, so chaos
tests can kill any write deterministically and assert the request is
cancelled and the allocator stays leak-free.

Two threads run next to the asyncio loop: the **engine thread** spins
``scheduler.tick()`` whenever there is work (parking on an event when
idle — the loop never busy-waits), and emitted tokens cross into the
loop via ``call_soon_threadsafe`` onto per-request ``asyncio.Queue``s.
The engine thread's CUDA work runs on that thread's current stream, the
card's default stream, which the kernels' per-(device, stream)
workspaces (``kernels/_build.stream_workspace``) already key; the HTTP
thread touches the scheduler only through its locked methods and never
launches device work (the ``/metrics`` leak probe is host bookkeeping).
A client that disconnects mid-stream is detected by the connection's
EOF watcher and its request is **cancelled through the scheduler** —
slot, pages, and prefix-cache pins return to the pool (the allocator
leak check stays clean; asserted in tests and the CI smoke).

``ServingServer.start()`` binds (port 0 = ephemeral, for tests/CI),
``serve_forever()`` blocks for CLI use, ``stop()`` shuts down the
engine thread, the loop, and every open stream cleanly.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading

from repro_torch.runtime.faults import InjectedFault, fault_point
from repro_torch.runtime.scheduler import PipelinedScheduler

_MAX_BODY = 8 << 20


class ServingServer:
    """HTTP/SSE front end over a ``PipelinedScheduler`` (see module doc)."""

    def __init__(self, scheduler: PipelinedScheduler, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_stream_queue: int = 256):
        if max_stream_queue < 1:
            raise ValueError(
                f"max_stream_queue must be >= 1, got {max_stream_queue}")
        self.scheduler = scheduler
        self.host, self.port = host, port
        self.max_stream_queue = max_stream_queue
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = None
        self._stop_flag = False
        self._started = False
        self._work = threading.Event()
        self._ready = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._engine_thread: threading.Thread | None = None

    # .. lifecycle ..
    def start(self) -> tuple[str, int]:
        """Bind and serve in background threads; returns (host, port)."""
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="serve-http", daemon=True)
        self._loop_thread.start()
        self._ready.wait()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="serve-engine", daemon=True)
        self._engine_thread.start()
        self._started = True
        return self.host, self.port

    @property
    def state(self) -> str:
        """Readiness state: "starting" until the engine thread spins,
        then the scheduler's own state (ready/degraded/draining)."""
        if not self._started:
            return "starting"
        return self.scheduler.state

    def serve_forever(self) -> None:
        """start() + block until stop() (or the loop dies)."""
        if self._loop_thread is None:
            self.start()
        self._loop_thread.join()

    def stop(self) -> None:
        """Shut down: engine thread first (drains its pipeline), then
        the asyncio loop and listener."""
        self._stop_flag = True
        self._work.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=30)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        server = loop.run_until_complete(
            asyncio.start_server(self._handle, self.host, self.port))
        self.port = server.sockets[0].getsockname()[1]
        self._server = server
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            server.close()
            loop.run_until_complete(server.wait_closed())
            # let cancelled handlers unwind before closing the loop
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.close()

    def _engine_loop(self) -> None:
        sched = self.scheduler
        while not self._stop_flag:
            if sched.busy:
                sched.yield_to_waiters()   # a cancel / submit / metrics read first
                sched.tick()
                if not (sched.engine._active or sched._prefill):
                    # busy but capacity-blocked (parked streams under a
                    # drain/shrink): nap instead of hot-spinning empty
                    # snapshot envelopes (read is a racy heuristic only)
                    self._work.wait(timeout=0.005)
                    self._work.clear()
            else:
                sched.flush()
                self._work.wait(timeout=0.02)
                self._work.clear()
        # drain whatever is still in flight so cancellations/frees land;
        # a capacity-blocked scheduler (parked streams, capacity 0) makes
        # no progress, so stop once two ticks change nothing runnable
        prev = None
        while sched.busy:
            sched.tick()
            cur = (len(sched.engine._active), sched._queued,
                   self.scheduler._prefill is not None,
                   len(sched.engine._parked), len(sched._pipeline))
            if cur == prev and not (sched.engine._active or sched._prefill):
                break
            prev = cur
        sched.flush()

    # .. http plumbing ..
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode("latin-1").split(None, 2)
            except ValueError:
                return
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            clen = int(headers.get("content-length", 0) or 0)
            if clen > _MAX_BODY:
                await self._respond(writer, 413, {"error": "body too large"})
                return
            body = await reader.readexactly(clen) if clen else b""

            if method == "GET" and path == "/healthz":
                state = self.state
                ok = state in ("ready", "degraded")
                await self._respond(writer, 200 if ok else 503,
                                    {"ok": ok, "state": state})
            elif method == "GET" and path == "/metrics":
                await self._respond(writer, 200, self._metrics())
            elif method == "POST" and path == "/v1/completions":
                await self._completions(reader, writer, body)
            else:
                await self._respond(writer, 404, {"error": "not found"})
        except (ConnectionError, asyncio.IncompleteReadError,
                InjectedFault):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _respond(self, writer, status: int, doc: dict) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        fault_point("server.write")
        payload = json.dumps(doc).encode()
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n".encode() + payload)
        await writer.drain()

    def _metrics(self) -> dict:
        doc = self.scheduler.stats()
        try:
            with self.scheduler._lock:     # leak check needs a tick boundary
                self.scheduler.engine.check_leaks()
            doc["leaks_clean"] = True
        except AssertionError:
            doc["leaks_clean"] = False
        return doc

    # .. completions ..
    async def _completions(self, reader, writer, body: bytes) -> None:
        try:
            req = json.loads(body or b"{}")
            tokens = req["tokens"]
            if (not isinstance(tokens, list) or not tokens
                    or not all(isinstance(t, int) for t in tokens)):
                raise ValueError("tokens must be a non-empty int list")
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            await self._respond(writer, 400, {"error": str(e)})
            return

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue(maxsize=self.max_stream_queue)
        uid_box: list[int] = []

        def on_token(tok: int, done: bool) -> None:
            # engine thread -> asyncio loop: the only crossing point
            def _put():
                try:
                    q.put_nowait((tok, done))
                except asyncio.QueueFull:
                    # slow-client policy: the socket's flow control and
                    # our bounded queue are both full — cancel the
                    # request and abort the connection rather than
                    # buffer an unbounded stream for a reader that
                    # isn't reading
                    if uid_box:
                        self.scheduler.cancel(uid_box[0])
                    with contextlib.suppress(Exception):
                        writer.transport.abort()
            loop.call_soon_threadsafe(_put)

        try:
            uid = self.scheduler.submit(
                tokens,
                max_new_tokens=int(req.get("max_new_tokens", 32)),
                temperature=float(req.get("temperature", 0.0)),
                priority=int(req.get("priority", 0)),
                deadline=(None if req.get("deadline") is None
                          else float(req["deadline"])),
                on_token=on_token)
        except ValueError as e:            # capacity validation
            await self._respond(writer, 400, {"error": str(e)})
            return
        if uid is None:                    # admission control: shed
            reason = ("draining" if self.scheduler.state == "draining"
                      else "queue full")
            await self._respond(writer, 429, {"error": reason})
            return
        uid_box.append(uid)
        self._work.set()

        if not req.get("stream", True):
            status, toks = await self._collect(reader, q, uid)
            if status == "disconnect":
                return                     # client went away: cancelled
            if status == "failed":
                await self._respond(writer, 500, {
                    "error": "request failed", "uid": uid,
                    "detail": self.scheduler.errors.get(uid)})
                return
            await self._respond(writer, 200, {"uid": uid, "tokens": toks})
            return
        await self._stream_sse(reader, writer, q, uid)

    async def _collect(self, reader, q, uid) -> tuple[str, list[int] | None]:
        eof = asyncio.ensure_future(reader.read())
        toks: list[int] = []
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
                # eof first: wait() reports EVERY completed future, and a
                # busy engine keeps the getter permanently ready — checking
                # the getter alone would never notice the disconnect
                if eof in done:
                    getter.cancel()
                    self.scheduler.cancel(uid)
                    return "disconnect", None
                tok, fin = getter.result()
                if tok is None and fin:    # quarantine failure sentinel
                    return "failed", None
                toks.append(tok)
                if fin:
                    return "ok", toks
        finally:
            eof.cancel()

    async def _stream_sse(self, reader, writer, q, uid) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")
        await writer.drain()
        # the EOF watcher is how a mid-stream disconnect is noticed:
        # reader.read() returns only when the client closes its end
        eof = asyncio.ensure_future(reader.read())
        toks: list[int] = []
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
                if eof in done:        # disconnect wins over pending tokens
                    getter.cancel()
                    self.scheduler.cancel(uid)
                    return
                tok, fin = getter.result()
                if tok is None and fin:    # quarantine failure sentinel
                    err = {"error": "failed", "uid": uid,
                           "detail": self.scheduler.errors.get(uid)}
                    fault_point("server.write", uid=uid)
                    writer.write(f"data: {json.dumps(err)}\n\n".encode())
                    await writer.drain()
                    return
                ev = {"index": len(toks), "token": tok}
                toks.append(tok)
                fault_point("server.write", uid=uid)
                writer.write(f"data: {json.dumps(ev)}\n\n".encode())
                await writer.drain()
                if fin:
                    fin_ev = {"done": True, "uid": uid, "tokens": toks}
                    fault_point("server.write", uid=uid)
                    writer.write(f"data: {json.dumps(fin_ev)}\n\n".encode())
                    await writer.drain()
                    return
        except (ConnectionError, asyncio.CancelledError, InjectedFault):
            # a failed/injected write mid-stream == the client vanished:
            # cancel through the scheduler so pages and pins come back
            self.scheduler.cancel(uid)
            raise
        finally:
            eof.cancel()
