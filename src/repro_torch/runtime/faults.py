"""Deterministic fault injection: the failure half of the serving stack.

The port's own copy of ``repro/runtime/faults.py`` (pure Python): the
same sites, triggers and seeded schedules, so a plan fires at the same
hits in both packages.

A production engine dies in ways a clean test suite never exercises —
an allocator that runs dry mid-tick, a poisoned decode dispatch, a
socket write into a vanished client, a host that stops heartbeating.
This module makes those failures FIRST-CLASS and DETERMINISTIC so chaos
tests can schedule "fault at hit N of site S for request K" exactly,
replay the same schedule bit-for-bit, and assert the recovery paths
(snapshot/rollback, retry, quarantine, elastic drain) actually hold.

* **Sites.** The runtime is instrumented with named injection points —
  ``fault_point(site, **ctx)`` calls that are free when no plan is
  active (one truthiness check).  The canonical sites:

  ==================  =====================================================
  ``allocator.alloc``  ``PageAllocator.alloc`` (page-pool pressure)
  ``decode.dispatch``  the batched decode tick, before the jit call
  ``prefill.dispatch`` admission prefill / a chunked-prefill window
  ``sampler``          the admission-time sampler call
  ``spec.verify``      the speculative verify burst
  ``server.write``     an HTTP/SSE socket write
  ``heartbeat``        a host heartbeat (raised = the beat is LOST)
  ==================  =====================================================

* **FaultPlan.** A context manager holding a list of :class:`Fault`
  triggers.  Each trigger names a site, the 0-based hit index it fires
  at, how many consecutive hits it covers, an optional ``uid`` filter
  (fire only when the instrumented call passes a matching ``uid``), and
  a kind: ``"error"`` raises :class:`InjectedFault`; ``"hang"`` sleeps
  ``seconds`` and returns (a stuck dispatch — the watchdog's prey).
  Plans nest (a stack); only the innermost active plan observes hits.
  ``plan.fired`` records every fault that actually triggered, in order,
  so a test can assert the schedule it asked for is the schedule it got.

* **Seeded chaos.** :func:`FaultPlan.seeded` derives a schedule from a
  PRNG seed — same seed, same schedule, every run — and named plans
  (``FaultPlan.named("ci-chaos")``) give the CLI/CI a stable handle.

Everything here is host-side and thread-safe: a fault fires inside the
scheduler lock on the engine thread, exactly where the real failure
would surface.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

#: the instrumented sites (kept in one place so tests and seeded plans
#: can enumerate them; instrumentation may pass any of these)
SITES = (
    "allocator.alloc",
    "decode.dispatch",
    "prefill.dispatch",
    "sampler",
    "spec.verify",
    "server.write",
    "heartbeat",
)


class InjectedFault(RuntimeError):
    """A scheduled fault firing at an instrumented site.

    Carries the site name, the hit index it fired at, and whatever
    context the instrumented call supplied (``uid=...`` lets recovery
    attribute the failure to one request).
    """

    def __init__(self, site: str, hit: int, ctx: dict):
        self.site = site
        self.hit = hit
        self.ctx = dict(ctx)
        self.uid = ctx.get("uid")
        at = f" uid={self.uid}" if self.uid is not None else ""
        super().__init__(f"injected fault at {site} (hit {hit}{at})")


@dataclass(frozen=True)
class Fault:
    """One trigger: fire at hits ``[at, at + times)`` of ``site``.

    ``uid``: only fire when the instrumented call passes a matching
    ``uid`` (hit counting is still global per site).  ``kind``:
    ``"error"`` raises; ``"hang"`` sleeps ``seconds`` then returns —
    the dispatch completes late, which is what a watchdog must catch.
    """

    site: str
    at: int = 0
    times: int = 1
    uid: int | None = None
    kind: str = "error"          # "error" | "hang"
    seconds: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {', '.join(SITES)}")
        if self.kind not in ("error", "hang"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 0 or self.times < 1:
            raise ValueError("need at >= 0 and times >= 1, "
                             f"got at={self.at}, times={self.times}")


@dataclass
class FiredFault:
    """One fault that actually triggered (the plan's replay record)."""

    site: str
    hit: int
    kind: str
    uid: int | None = None


# innermost-active-plan stack; fault_point is a no-op when empty
_ACTIVE: list["FaultPlan"] = []
_STACK_LOCK = threading.Lock()


class FaultPlan:
    """A deterministic schedule of faults over the instrumented sites.

    Use as a context manager (tests) or via ``activate()``/
    ``deactivate()`` (a server that outlives the calling frame)::

        with FaultPlan([Fault("decode.dispatch", at=3)]):
            scheduler.run()     # tick 3's dispatch raises InjectedFault

    ``hits`` counts every observation per site (fired or not);
    ``fired`` records the faults that triggered, in order.
    """

    def __init__(self, faults=(), *, name: str = "", sleep=time.sleep):
        self.name = name
        self.faults = list(faults)
        self.hits: dict[str, int] = {}
        self.fired: list[FiredFault] = []
        self._sleep = sleep
        self._lock = threading.Lock()

    # .. lifecycle ..
    def activate(self) -> "FaultPlan":
        with _STACK_LOCK:
            _ACTIVE.append(self)
        return self

    def deactivate(self) -> None:
        with _STACK_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)

    def __enter__(self) -> "FaultPlan":
        return self.activate()

    def __exit__(self, *exc) -> None:
        self.deactivate()

    # .. observation ..
    def observe(self, site: str, ctx: dict) -> None:
        """Count one hit of ``site``; raise/sleep when a trigger matches."""
        with self._lock:
            hit = self.hits.get(site, 0)
            self.hits[site] = hit + 1
            trig = None
            for f in self.faults:
                if (f.site == site and f.at <= hit < f.at + f.times
                        and (f.uid is None or f.uid == ctx.get("uid"))):
                    trig = f
                    break
            if trig is None:
                return
            self.fired.append(FiredFault(site, hit, trig.kind,
                                         ctx.get("uid")))
        # sleep OUTSIDE the plan lock: a hang must not serialize other
        # threads' observations
        if trig.kind == "hang":
            self._sleep(trig.seconds)
            return
        raise InjectedFault(site, hit, ctx)

    # .. constructors ..
    @classmethod
    def seeded(cls, seed: int, *, sites=SITES, faults_per_site: int = 1,
               max_at: int = 12, name: str = "") -> "FaultPlan":
        """Deterministic chaos schedule: ``faults_per_site`` error
        faults per site, hit indices drawn from ``random.Random(seed)``
        in a fixed site order — same seed, same schedule, every run."""
        rng = random.Random(seed)
        faults = [Fault(site, at=rng.randrange(max_at))
                  for site in sites
                  for _ in range(faults_per_site)]
        return cls(faults, name=name or f"seeded-{seed}")

    @classmethod
    def named(cls, name: str) -> "FaultPlan":
        """A registered plan by name (the CLI's ``--fault-plan``)."""
        try:
            return _NAMED[name]()
        except KeyError:
            raise ValueError(
                f"unknown fault plan {name!r}; known: "
                f"{', '.join(sorted(_NAMED))}") from None


def _ci_chaos() -> FaultPlan:
    # one early fault in each recoverable engine category: the CI smoke
    # drives a live server through allocator, prefill, decode and
    # sampler failures and still expects every stream to finish or be
    # reported failed — with a clean leak check at shutdown
    return FaultPlan([
        Fault("allocator.alloc", at=1),
        Fault("prefill.dispatch", at=2),
        Fault("decode.dispatch", at=3),
        Fault("decode.dispatch", at=9),
        Fault("sampler", at=1),
    ], name="ci-chaos")


_NAMED = {
    "ci-chaos": _ci_chaos,
}


def fault_point(site: str, **ctx) -> None:
    """Instrumentation hook: observe ``site`` on the innermost active
    plan (no-op — one truthiness check — when no plan is active)."""
    if not _ACTIVE:
        return
    plan = _ACTIVE[-1]
    plan.observe(site, ctx)


def active_plan() -> FaultPlan | None:
    """The innermost active plan, if any (diagnostics/CLI reporting)."""
    return _ACTIVE[-1] if _ACTIVE else None
