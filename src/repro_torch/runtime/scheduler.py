"""Pipelined prefill/decode scheduler: the async half of the serving stack
(port of ``repro/runtime/scheduler.py``).

``ServeEngine.run`` is a synchronous admit -> dispatch -> block loop:
every tick the host pulls the sampled tokens (``.cpu()``) before it may
dispatch the next, so the card idles during host bookkeeping, and a long
prompt's admission prefill stalls every decoder for its whole length.
:class:`PipelinedScheduler` drives the SAME engine (same model, page
allocator and per-request generators) with two structural changes, and
emits bit-identical streams while doing it:

1. **Pipelined decode.**  Tick N+1 is dispatched before tick N's sampled
   tokens reach the host: the sampler's [slots] token tensor stays on the
   card and feeds the next tick (``_feed``), and the host processes tick
   N's tokens (EOS checks, emission, slot frees) while tick N+1 runs.
   The one blocking pull (``.cpu()``) happens when an entry leaves the
   pipeline; ``flush`` synchronises the card at the stream boundary.
   The engine learns that a slot finished only when its token is
   processed, so a dispatch-ahead tick may write one position past the
   host mirror: admission reserves ``pipeline_depth`` extra positions a
   request (``ServeEngine._reserve_slack``), as speculative ticks
   reserve ``spec_k``, and every dispatch runs
   ``_map_tick_pages(len(pipeline))``, so that write lands only in a page
   the slot holds alone (or the null page), never in prefix-shared
   bytes.  A processed entry whose slot was freed or re-admitted since is
   dropped by a uid guard.  The pools are written in place, so the
   lineage of a tick is the pool itself: tick N+1's kernels follow tick
   N's on the stream.  Every host array a tick needs (the block table,
   the park mask and positions) goes up by a pinned non-blocking upload
   (:func:`repro_torch.device.upload`): a tick at depth 1 never waits
   for the card outside entry processing.

2. **Split prefill/decode streams.**  On the paged + prefix-cache engine
   without a drafter, admission is no longer one prefill plus a host
   sync.  The prompt's unshared suffix prefills in grid-aligned chunks
   (windows of ``prefill_chunk`` tokens ending at absolute multiples of
   it), ONE chunk a tick between decode dispatches, each a
   ``Model.apply(write_cache=True, pos0=lo)`` over the slot's view (the
   last with ``last_only`` and ``last_index``).  While a slot is
   mid-prefill it is parked: the decode tick's position override pins
   its device position to the chunk frontier, whose write lands in the
   slot's own page (or the null page) and is overwritten by the next
   chunk before any position-bounded read sees it.  A fully cached
   prompt peeks through the engine's ``_peek``.  The first sampled token
   stays on the card (it feeds the next tick) and its emission rides the
   pipeline as an admit record, so admission never syncs.  Chunk
   boundaries do not change the plain path's numbers (each row is
   projected and attended on its own), so streams equal the synchronous
   engine's bit for bit (``tests/test_torch_scheduler.py``).

   Dense engines and speculative engines admit atomically through
   ``_admit_one`` (speculative engines tick through ``engine.step()``:
   the verify burst is the decode stream); they keep admission control
   and metrics, and dense engines keep pipelined decode.

On top sit the serving policies: **admission control** (``max_queue``:
a submit past it is shed with ``None``, a 429, never a stall),
**priorities** (lower admits first, FIFO within one) and **deadlines**
(a request still queued past its deadline is shed, not started).
Every lifecycle event feeds a :class:`ServingMetrics`.

Threads: one re-entrant lock guards every public method, so an HTTP
thread may ``submit`` / ``cancel`` while the engine thread runs
``tick``.  CUDA work runs on the ticking thread's current stream (the
default stream of the card, whose split-K and paged workspaces
``kernels/_build.stream_workspace`` keys by (device, stream)).

FAULT TOLERANCE (``max_retries`` / ``watchdog_timeout`` / ``degrade``,
any of them): every tick runs inside a snapshot / rollback envelope.  The
scheduler captures the engine (``ServeEngine.snapshot``: pools cloned,
generator states captured) and its own queue and status state at the
tick boundary, runs the tick, and on any raised fault (injected through
``runtime/faults.py``, organic, or the watchdog's) restores both and
retries.  Fault-tolerant mode forces ``pipeline_depth = 0``: a snapshot
with ticks in flight would capture device positions ahead of the host
mirror; and at depth 0 a tick ends in a host pull, so the watchdog's
host clock covers the card's work.  Retries replay deterministically
(per-request generators, restored with their states), and tokens the
client already saw are suppressed by a forwarded-count guard (``_fwd``
never rolls back, ``_progress`` does).  A request that keeps failing
past ``max_retries`` is QUARANTINED: removed wherever it is, reported in
``errors[uid]``, its stream closed with a ``(None, True)`` sentinel.  A
fault that names no uid blames the oldest active request once the
anonymous streak passes the same budget.  A :class:`DegradePolicy`
escalates one level per recovered fault (1: speculative bursts off; 2:
half the prefill chunk; 3: shed the worst queued request) and walks back
down on clean ticks.

ELASTIC CAPACITY (``set_capacity`` / ``drain``): shrinking below the
occupancy PARKS the youngest streams (``ServeEngine.park_slot``: pages
stay resident, the slot frees) and resumes them, oldest first, ahead of
new admissions when capacity returns.  ``drain`` stops admission (new
submits shed as "draining"); ``undrain`` reopens.
``runtime.elastic.ElasticSupervisor`` drives both from heartbeats.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import upload
from repro_torch.runtime import sampling
from repro_torch.runtime.faults import fault_point


class _TurnLock:
    """A re-entrant lock that counts the threads blocked on it.  Python's
    locks are not fair: a thread that releases one and takes it again at
    once (a tick loop) wins it back nearly every time under CPU contention,
    and a control call from another thread (``cancel`` from the HTTP loop
    on a client's disconnect) can starve until the stream has finished.
    ``waiting`` lets such a loop step aside first
    (``PipelinedScheduler.yield_to_waiters``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._count = threading.Lock()
        self.waiting = 0

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            with self._count:
                self.waiting += 1
            self._lock.acquire()
            with self._count:
                self.waiting -= 1
        return self

    def __exit__(self, *exc):
        self._lock.release()
from repro_torch.runtime.metrics import ServingMetrics
from repro_torch.runtime.serve_loop import Request, ServeEngine, _set_slot, _SlotState

QUEUED, PREFILL, ACTIVE = "queued", "prefill", "active"
DONE, SHED, CANCELLED = "done", "shed", "cancelled"
PARKED, FAILED = "parked", "failed"


class WatchdogTimeout(RuntimeError):
    """A tick exceeded the watchdog budget (a stuck or poisoned dispatch)."""


@dataclass
class DegradePolicy:
    """Graceful-degradation ladder for the fault-tolerant scheduler.

    Each recovered fault escalates one level; ``recover_after``
    consecutive clean ticks walk one level back down:

    * level 1: speculative bursts off (``engine.spec_enabled``); with
      ``spec_mode="match"`` the streams are the same either way;
    * level 2: half the prefill chunk window (floored at ``min_chunk``);
    * level 3: shed the lowest-priority queued request at each further
      escalation.
    """

    min_chunk: int = 8
    recover_after: int = 16

    def __post_init__(self):
        if self.min_chunk < 1:
            raise ValueError(f"min_chunk must be >= 1, got {self.min_chunk}")
        if self.recover_after < 1:
            raise ValueError(f"recover_after must be >= 1, got {self.recover_after}")


@dataclass(order=True)
class _QEntry:
    priority: int
    seq: int
    req: Request = field(compare=False)
    deadline: float | None = field(compare=False, default=None)
    queued_ns: int = field(compare=False, default=0)   # submit (time_ns): req.queued's start


@dataclass
class _Entry:
    """One dispatched, not yet processed decode tick."""
    tok_dev: torch.Tensor | None        # [slots] sampled tokens on the card
    active: list                        # [(slot, uid)] at dispatch
    admits: list = field(default_factory=list)   # [(slot, uid, tok [1] on the card)]


@dataclass
class _Prefill:
    """A chunked admission in flight: positions [lo, n) still to write."""
    slot: int
    req: Request
    lo: int                             # frontier: next position to prefill
    n: int                              # prompt length


class PipelinedScheduler:
    """Asynchronous front-end scheduler over a :class:`ServeEngine`.

    engine: the idle engine to drive (the scheduler owns admission: do
        not mix with ``engine.submit`` / ``engine.run``).
    pipeline_depth: decode ticks in flight past the host (0: processed in
        the tick that dispatched them; 1: the host works on tick N while
        tick N+1 runs).
    max_queue: queued-request bound; ``submit`` past it returns None.
    prefill_chunk: chunk-grid width of split-stream admission (default:
        the engine's ``prefill_chunk``, else 32).
    metrics: a ``ServingMetrics`` to record into (default: a fresh one).
    clock: the host clock of deadlines and the watchdog.
    max_retries: per-request retry budget after a recovered fault; past
        it the request is quarantined (FAILED, ``errors[uid]``).
    watchdog_timeout: seconds one tick may take before it counts as
        stuck and is rolled back and retried.
    degrade: a :class:`DegradePolicy`.
    Any of the last three turns fault-tolerant ticking on (and forces
    ``pipeline_depth = 0``; every tick then pays one engine snapshot).
    """

    def __init__(self, engine: ServeEngine, *, pipeline_depth: int = 1,
                 max_queue: int = 256, prefill_chunk: int | None = None,
                 metrics: ServingMetrics | None = None, clock=time.monotonic,
                 max_retries: int = 0, watchdog_timeout: float | None = None,
                 degrade: DegradePolicy | None = None):
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {pipeline_depth}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError(f"watchdog_timeout must be > 0, got {watchdog_timeout}")
        if engine._active or engine._queue:
            raise ValueError("scheduler must take over an idle engine")
        self.engine = engine
        self.max_retries = max_retries
        self.watchdog_timeout = watchdog_timeout
        self.degrade = degrade
        self._ft = max_retries > 0 or watchdog_timeout is not None or degrade is not None
        self.depth = 0 if engine._spec or self._ft else pipeline_depth
        self.max_queue = max_queue
        self.chunk = max(1, prefill_chunk or engine.prefill_chunk or 32)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._clock = clock
        # dispatch-ahead ticks write past the host pos mirror: widen every
        # reservation by the depth BEFORE any admission
        engine._reserve_slack = self.depth
        self._chunked = engine._paged and engine._prefix is not None and not engine._spec
        self._lock = _TurnLock()
        self._heap: list[_QEntry] = []
        self._seq = 0
        self._queued = 0                 # live (not cancelled) heap entries
        self._status: dict[int, str] = {}
        self._streams: dict[int, object] = {}   # uid -> cb(tok, done)
        self._pipeline: deque[_Entry] = deque()
        self._prefill: _Prefill | None = None
        self._tok_dev = None             # [slots] int64 token feed on the card
        self._park_mask = np.zeros((engine.slots,), bool)
        self._park_pos = np.zeros((engine.slots,), np.int32)
        self._chain_on_token = engine.on_token
        engine.on_token = self._on_token

        # .. fault-tolerance / elastic state ..
        self.errors: dict[int, dict] = {}      # uid -> structured failure
        self._retry_counts: dict[int, int] = {}
        self._fail_streak = 0                  # consecutive anonymous faults
        self._clean_ticks = 0
        self._degrade_level = 0
        self._base_chunk = self.chunk
        # emission dedup across rollbacks: ``_progress`` counts tokens the
        # ENGINE emitted per uid (rolls back with the snapshot), ``_fwd``
        # those the CLIENT saw (never rolls back)
        self._progress: dict[int, int] = {}
        self._fwd: dict[int, int] = {}
        self._capacity = engine.slots
        self._draining = False

    # .. intake ..
    def submit(self, tokens, *, max_new_tokens: int = 32, temperature: float = 0.0,
               priority: int = 0, deadline: float | None = None,
               on_token=None) -> int | None:
        """Queue a request; returns its uid, or None when shed (queue full
        or draining: the caller answers 429).  ``priority``: lower admits
        first.  ``deadline``: seconds from now; still queued past it, the
        request is shed.  ``on_token(tok, done)`` streams tokens (called
        under the scheduler lock: keep it quick)."""
        with self._lock:
            if self._draining:
                self.metrics.shed("draining")
                return None
            if self._queued >= self.max_queue:
                self.metrics.shed("queue_full")
                return None
            # engine.submit validates capacity and mints the uid; the request
            # then moves to the scheduler's own queue
            uid = self.engine.submit(tokens, max_new_tokens=max_new_tokens,
                                     temperature=temperature)
            req = self.engine._queue.pop()
            self._seq += 1
            heapq.heappush(self._heap, _QEntry(
                priority, self._seq, req,
                None if deadline is None else self._clock() + deadline,
                queued_ns=time.time_ns()))
            self._queued += 1
            self._status[uid] = QUEUED
            if on_token is not None:
                self._streams[uid] = on_token
            self.metrics.submitted(uid)
            return uid

    def cancel(self, uid: int) -> bool:
        """Abort ``uid`` wherever it is (queued, mid-prefill, decoding or
        parked): slot, pages and prefix-cache pins are released and no
        result is recorded.  False for unknown or finished uids."""
        with self._lock:
            st = self._status.get(uid)
            if st not in (QUEUED, PREFILL, ACTIVE, PARKED):
                return False
            if st == QUEUED:
                self._queued -= 1        # the heap entry dies lazily at pop
            elif st == PREFILL:
                self._drop_prefill()
            elif st == PARKED:
                self.engine.drop_parked(uid)
            else:
                self.engine.cancel(uid)
            self._status[uid] = CANCELLED
            self._streams.pop(uid, None)
            self.metrics.cancelled(uid)
            return True

    def _drop_prefill(self) -> None:
        """Release the slot of the chunked admission in flight."""
        pf = self._prefill
        self._prefill = None
        self._park_mask[pf.slot] = False
        self.engine._release_slot(pf.slot)

    def status(self, uid: int) -> str | None:
        with self._lock:
            return self._status.get(uid)

    @property
    def results(self) -> dict[int, list[int]]:
        with self._lock:
            return dict(self.engine._results)

    @property
    def busy(self) -> bool:
        with self._lock:
            return bool(self._queued or self.engine._active or self._prefill
                        or self._pipeline or self.engine._parked)

    @property
    def state(self) -> str:
        """"draining" | "degraded" | "ready" (the server adds "starting")."""
        with self._lock:
            if self._draining:
                return "draining"
            if self._degrade_level > 0:
                return "degraded"
            return "ready"

    # .. emission ..
    def _on_token(self, uid: int, tok: int, done: bool) -> None:
        cur = self._progress.get(uid, 0) + 1
        self._progress[uid] = cur
        if cur <= self._fwd.get(uid, 0):
            # a retried tick re-emitting a token the client already saw
            if done:
                self._status[uid] = DONE
            return
        self._fwd[uid] = cur
        self.metrics.token(uid)
        if done:
            self.metrics.finished(uid)
            self._status[uid] = DONE
        cb = self._streams.get(uid)
        if cb is not None:
            cb(tok, done)
            if done:
                del self._streams[uid]
        if self._chain_on_token is not None:
            self._chain_on_token(uid, tok, done)

    # .. decode stream ..
    def _feed(self) -> torch.Tensor:
        if self._tok_dev is None:
            self._tok_dev = upload(self.engine._next_tok, self.engine.device, np.int64)
        return self._tok_dev

    def _set_feed(self, slot: int, tok) -> None:
        """Put ``tok`` (an int, or a one-element tensor on the card) in the
        feed at ``slot``.  A copy: the old feed is an in-flight entry's
        token tensor, which the host still pulls."""
        feed = self._feed().clone()
        if torch.is_tensor(tok):
            feed[slot].copy_(tok)       # a device-to-device copy
        else:
            feed[slot].fill_(tok)       # no pageable staging (see _set_slot)
        self._tok_dev = feed

    def _dispatch_decode(self) -> _Entry:
        eng = self.engine
        fault_point("decode.dispatch")
        # a dispatch-ahead tick writes up to len(pipeline) positions past
        # the host mirror: make that whole span write-safe first
        eng._map_tick_pages(len(self._pipeline))
        toks = self._feed()
        cache = eng.cache
        if self._park_mask.any():
            # a slot mid-prefill decodes at its chunk frontier
            pmask = upload(self._park_mask, eng.device)
            ppos = upload(self._park_pos, eng.device)
            cache = dict(cache, pos=torch.where(pmask, ppos, cache["pos"]))
        fault_point("sampler")
        logits, eng.cache = eng.model.decode_step(eng.params, cache, toks)
        if eng._temp.any() or eng._truncates:
            tok, _ = eng._sampler(logits, eng._keys, eng._temp)
        else:
            tok = sampling.greedy(logits)
        self._tok_dev = tok.long()
        return _Entry(self._tok_dev, [(s, st.req.uid) for s, st in eng._active.items()])

    def _process_entry(self, entry: _Entry) -> None:
        eng = self.engine
        toks = None if entry.tok_dev is None else entry.tok_dev.cpu().numpy()
        for slot, uid in entry.active:
            st = eng._active.get(slot)
            if st is None or st.req.uid != uid:
                continue        # finished or cancelled after this dispatch
            eng._pos[slot] += 1
            eng._emit(slot, int(toks[slot]))
        for slot, uid, tdev in entry.admits:
            st = eng._active.get(slot)
            if st is None or st.req.uid != uid:
                continue        # cancelled between admission and here
            eng._emit(slot, int(tdev.cpu()[0]))

    # .. prefill stream ..
    def _pop_ready(self, now: float) -> Request | None:
        """Next admissible request: drops cancelled heap entries and sheds
        queued requests whose deadline passed."""
        while self._heap:
            qe = heapq.heappop(self._heap)
            uid = qe.req.uid
            if self._status.get(uid) != QUEUED:
                continue                       # cancelled: lazy delete
            if qe.deadline is not None and now > qe.deadline:
                self._queued -= 1
                self._status[uid] = SHED
                self._streams.pop(uid, None)
                self.metrics.shed("deadline")
                continue
            self._qe_backout = qe              # for the pool-dry push back
            self._queued -= 1
            return qe.req
        return None

    def _push_back(self) -> None:
        heapq.heappush(self._heap, self._qe_backout)
        self._queued += 1
        self._status[self._qe_backout.req.uid] = QUEUED

    def _occupied(self) -> int:
        return len(self.engine._active) + (1 if self._prefill else 0)

    def _admit_loop(self, now: float) -> None:
        eng = self.engine
        # parked streams resume first, oldest first: their pages are still
        # resident, so resuming costs no prefill and frees capacity soonest
        while eng._parked and eng._free and self._occupied() < self._capacity:
            uid = min(eng._parked)
            slot = eng.resume_parked(uid)
            self._status[uid] = ACTIVE
            self.metrics.resumed(uid)
            self._set_feed(slot, int(eng._next_tok[slot]))
        if self._draining:
            return
        while eng._free and self._prefill is None and self._occupied() < self._capacity:
            req = self._pop_ready(now)
            if req is None:
                return
            slot = eng._free[-1]
            if self._chunked:
                ok = self._start_admission(slot, req)
            else:
                ok = eng._admit_one(slot, req)
                if ok:
                    eng._free.remove(slot)
                    self._status[req.uid] = ACTIVE
                    self._admitted(req.uid)
                    if slot in eng._active:   # not done at its first token
                        self._set_feed(slot, int(eng._next_tok[slot]))
            if not ok:
                self._push_back()             # pool dry: wait for an EOS
                return
            if self._prefill is not None:
                # a multi-chunk admission paces itself one chunk a tick
                self._advance_chunk()
                return

    def _admitted(self, uid: int) -> None:
        """``uid`` (the entry ``_pop_ready`` returned last) left the queue."""
        self.metrics.admitted(uid)
        tracing.close("req.queued", self._qe_backout.queued_ns, uid=uid)

    def _start_admission(self, slot: int, req: Request) -> bool:
        """Begin split-stream admission: map the prompt's pages (shared
        prefix + fresh suffix), then either finish at once (a fully cached
        prompt: one peek) or park the slot and hand the suffix to the chunk
        stream."""
        eng = self.engine
        fault_point("prefill.dispatch", uid=req.uid)
        pos0 = eng._map_prefix(slot, req)
        if pos0 is None:
            return False
        eng._free.remove(slot)
        self._admitted(req.uid)
        n = len(req.tokens)
        if pos0 >= n:
            layers = [c.prefill_view(slot) for c in eng.cache["layers"]]
            self._complete_admission(slot, req, eng._peek(req.tokens[-1], layers, n - 1))
        else:
            self._prefill = _Prefill(slot, req, pos0, n)
            self._status[req.uid] = PREFILL
            self._park_mask[slot] = True
            self._park_pos[slot] = pos0
        return True

    def _advance_chunk(self) -> None:
        """Run ONE grid-aligned prefill chunk of the admission in flight;
        the last completes it.  Windows end at absolute multiples of
        ``self.chunk`` (capped at the block table's reach); the last is
        tail-padded to its window, its last real row's logits picked by
        ``last_index``."""
        pf = self._prefill
        eng, req, slot, lo = self.engine, pf.req, pf.slot, pf.lo
        fault_point("prefill.dispatch", uid=req.uid)
        cap = eng._pps * eng.page_size
        hi = min((lo // self.chunk + 1) * self.chunk, cap)
        real_hi = min(hi, pf.n)
        toks = upload([req.tokens[lo:real_hi] + [eng.pad_id] * (hi - real_hi)],
                      eng.device, np.int64)
        cache = {"layers": [c.prefill_view(slot) for c in eng.cache["layers"]], "pos": lo}
        if real_hi < pf.n:
            eng.model.apply(eng.params, toks, cache=cache, write_cache=True,
                            need_logits=False, pos0=lo)
            pf.lo = hi
            self._park_pos[slot] = hi         # the frontier moved
        else:
            out = eng.model.apply(eng.params, toks, cache=cache, write_cache=True,
                                  last_only=True, pos0=lo, last_index=pf.n - 1 - lo)
            self._prefill = None
            self._park_mask[slot] = False
            self._complete_admission(slot, req, out["logits"][:, 0])

    def _complete_admission(self, slot: int, req: Request, logits) -> None:
        """Activate the slot and sample the first token without a host
        sync: the token stays on the card (it feeds the next decode tick)
        and its emission rides the pipeline as an admit record."""
        eng, n = self.engine, len(req.tokens)
        eng._prefix.insert(req.tokens, [int(p) for p in eng._table[slot, :n // eng.page_size]])
        _set_slot(eng.cache, slot, n, 0)
        eng._pos[slot] = n
        eng._active[slot] = _SlotState(req)
        eng._temp[slot] = req.temperature
        eng._keys[slot] = sampling.seed_generator(eng.seed, req.uid, eng.device)
        fault_point("sampler", uid=req.uid)
        tok, _ = eng._sampler(logits, eng._keys[slot:slot + 1], eng._temp[slot:slot + 1])
        self._set_feed(slot, tok[0])
        self._status[req.uid] = ACTIVE
        record = (slot, req.uid, tok)
        if self._pipeline:
            self._pipeline[-1].admits.append(record)
        else:
            self._pipeline.append(_Entry(None, [], [record]))

    # .. driving ..
    def yield_to_waiters(self, timeout: float = 0.05) -> None:
        """Let threads blocked on the scheduler's lock (a cancel, a submit, a
        metrics read) take it before the caller's next tick, for at most
        ``timeout`` seconds; a loop that ticks back to back calls it
        between ticks."""
        deadline = time.monotonic() + timeout
        while self._lock.waiting and time.monotonic() < deadline:
            time.sleep(0.0002)

    def tick(self) -> bool:
        """One scheduler tick: dispatch the next decode tick (if a slot is
        decoding), advance the prefill stream by one chunk or admission,
        then process the pipeline entries past the allowed depth.  In
        fault-tolerant mode the tick runs inside the snapshot / rollback
        envelope.  Returns True while there is (or will be) work."""
        with self._lock, tracing.span("sched.tick"):
            if not self._ft:
                return self._tick_inner()
            return self._tick_ft()

    def _tick_inner(self) -> bool:
        now = self._clock()
        eng = self.engine
        if eng._spec:
            # the draft / verify burst is its own host-synced stream:
            # admission control and metrics apply, pipelining does not (a
            # degraded engine, spec_enabled off, decodes plainly in step())
            self._admit_loop(now)
            if eng._active:
                eng.step()
            self._gauges()
            return self.busy
        dispatched = False
        if eng._active:
            with tracing.span("sched.decode", rows=len(eng._active)):
                self._pipeline.append(self._dispatch_decode())
            dispatched = True
        if self._prefill is not None:
            self._advance_chunk()
        self._admit_loop(now)
        limit = self.depth if dispatched else 0
        while len(self._pipeline) > limit:
            self._process_entry(self._pipeline.popleft())
        self._gauges()
        return self.busy

    # .. fault-tolerant envelope ..
    def _snap_all(self) -> tuple:
        pf = self._prefill
        return (self.engine.snapshot(), list(self._heap), self._queued, self._seq,
                dict(self._status), dict(self._progress),
                None if pf is None else _Prefill(pf.slot, pf.req, pf.lo, pf.n),
                self._park_mask.copy(), self._park_pos.copy())

    def _restore_all(self, snap: tuple) -> None:
        (esnap, heap, queued, seq, status, progress, pf, park_mask, park_pos) = snap
        self.engine.restore(esnap)
        self._heap = list(heap)       # entries are never mutated in place
        self._queued = queued
        self._seq = seq
        self._status = dict(status)
        self._progress = dict(progress)
        self._prefill = None if pf is None else _Prefill(pf.slot, pf.req, pf.lo, pf.n)
        self._park_mask = park_mask.copy()
        self._park_pos = park_pos.copy()
        self._pipeline.clear()        # depth 0: nothing in flight anyway
        self._tok_dev = None          # the feed rebuilds from the host mirror

    def _tick_ft(self) -> bool:
        snap = self._snap_all()
        t0 = self._clock()
        try:
            out = self._tick_inner()
            if (self.watchdog_timeout is not None
                    and self._clock() - t0 > self.watchdog_timeout):
                self.metrics.watchdog_trip()
                raise WatchdogTimeout(
                    f"tick exceeded the {self.watchdog_timeout}s watchdog budget: "
                    "treating the dispatch as stuck")
        except Exception as exc:                    # noqa: BLE001
            self._recover(snap, exc)
            return self.busy
        self._fail_streak = 0
        if self.degrade is not None and self._degrade_level:
            self._clean_ticks += 1
            if self._clean_ticks >= self.degrade.recover_after:
                self._degrade_level -= 1
                self._clean_ticks = 0
                self._apply_degrade()
        return out

    def _recover(self, snap: tuple, exc: Exception) -> None:
        """Roll back to the tick-boundary snapshot, attribute blame, and
        either retry (a deterministic replay next tick) or quarantine."""
        site = getattr(exc, "site", None) or (
            "watchdog" if isinstance(exc, WatchdogTimeout) else "internal")
        self.metrics.fault(site)
        self._restore_all(snap)
        self.engine.check_leaks()     # a rollback leaves no drift
        uid = getattr(exc, "uid", None)
        if uid is not None:
            self._retry_counts[uid] = self._retry_counts.get(uid, 0) + 1
            if self._retry_counts[uid] > self.max_retries:
                self._quarantine(uid, exc, site)
            else:
                self.metrics.retried(uid)
        else:
            self._fail_streak += 1
            if self._fail_streak > self.max_retries:
                # an anonymous fault that keeps recurring: quarantine the
                # oldest in-flight request as the deterministic scapegoat
                victim = self._blame_victim()
                if victim is not None:
                    self._quarantine(victim, exc, site)
                self._fail_streak = 0
            else:
                self.metrics.retried()
        if self.degrade is not None:
            self._degrade_level = min(3, self._degrade_level + 1)
            self._clean_ticks = 0
            self._apply_degrade()
            if self._degrade_level >= 3:
                self._shed_worst()

    def _blame_victim(self) -> int | None:
        eng = self.engine
        if eng._active:
            return min(st.req.uid for st in eng._active.values())
        if self._prefill is not None:
            return self._prefill.req.uid
        live = [qe for qe in self._heap if self._status.get(qe.req.uid) == QUEUED]
        return min(live).req.uid if live else None

    def _quarantine(self, uid: int, exc: Exception, site: str) -> None:
        """Fail ``uid`` for good: release what it holds, record a structured
        error and close its stream with a (None, True) sentinel."""
        eng = self.engine
        st = self._status.get(uid)
        if st == QUEUED:
            self._queued -= 1              # the heap entry dies lazily at pop
        elif st == PREFILL and self._prefill is not None and self._prefill.req.uid == uid:
            self._drop_prefill()
        elif st == PARKED:
            eng.drop_parked(uid)
        else:
            eng.cancel(uid)
        self._status[uid] = FAILED
        self.errors[uid] = {"uid": uid, "site": site, "error": type(exc).__name__,
                            "message": str(exc), "retries": self._retry_counts.get(uid, 0)}
        self.metrics.quarantined(uid)
        cb = self._streams.pop(uid, None)
        if cb is not None:
            cb(None, True)

    def _apply_degrade(self) -> None:
        lvl = self._degrade_level
        if self.engine._spec:
            self.engine.spec_enabled = lvl < 1
        self.chunk = (self._base_chunk if lvl < 2
                      else max(self.degrade.min_chunk, self._base_chunk // 2))
        self.metrics.set_degrade_level(lvl)

    def _shed_worst(self) -> None:
        live = [qe for qe in self._heap if self._status.get(qe.req.uid) == QUEUED]
        if not live:
            return
        victim = max(live, key=lambda qe: (qe.priority, qe.seq))
        self._queued -= 1                  # the heap entry dies lazily at pop
        self._status[victim.req.uid] = SHED
        self._streams.pop(victim.req.uid, None)
        self.metrics.shed("degraded")

    # .. elastic capacity ..
    def set_capacity(self, n: int) -> None:
        """Serve at most ``n`` slots at once.  Shrinking below the occupancy
        PARKS the youngest active streams (pages stay resident;
        ``resume_parked`` continues them bit for bit when capacity
        returns).  Engines that cannot park (dense, speculative) shrink by
        attrition: no new admissions until occupancy fits."""
        with self._lock:
            self._capacity = max(0, min(n, self.engine.slots))
            self._enforce_capacity()

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    def _enforce_capacity(self) -> None:
        eng = self.engine
        if not eng._paged or eng._spec:
            return                         # attrition-only shrink
        # process the ticks in flight first, so parking sees settled state
        while self._pipeline:
            self._process_entry(self._pipeline.popleft())
        self._tok_dev = None
        while self._occupied() > self._capacity and eng._active:
            slot = max(eng._active, key=lambda s: eng._active[s].req.uid)
            uid = eng.park_slot(slot)
            self._status[uid] = PARKED
            self.metrics.parked(uid)

    def drain(self) -> None:
        """Stop admitting: queued requests wait, new submits shed as
        "draining" (429), in-flight streams run to completion."""
        with self._lock:
            self._draining = True

    def undrain(self) -> None:
        with self._lock:
            self._draining = False

    def _gauges(self) -> None:
        self.metrics.set_queue_depth(self._queued, len(self.engine._active)
                                     + (1 if self._prefill else 0))

    def flush(self) -> None:
        """Process every tick in flight and synchronise the card: the
        stream-boundary barrier."""
        with self._lock:
            while self._pipeline:
                self._process_entry(self._pipeline.popleft())
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)

    def run(self) -> dict[int, list[int]]:
        """Drive until every queued and active request drains, then flush,
        leak-check and return ``{uid: tokens}`` (shed and cancelled uids
        are absent: see ``status``)."""
        while self.tick():
            pass
        self.flush()
        self.engine.check_leaks()
        return self.results

    def stats(self) -> dict:
        """The metrics document (``ServingMetrics.snapshot``) plus the
        engine's page, prefix-cache and spec counters where present."""
        with self._lock:
            eng = self.engine
            extra = {"state": self.state, "capacity": self._capacity,
                     "parked": len(eng._parked), "failed": len(self.errors)}
            if eng.page_stats is not None:
                extra["pages"] = eng.page_stats
            if eng.prefix_stats is not None:
                extra["prefix_cache"] = eng.prefix_stats
            return self.metrics.snapshot(
                spec_stats=dict(eng.spec_stats) if eng._spec else None, extra=extra)
