"""Elastic scaling, failure recovery, and straggler mitigation.

The port's own copy of ``repro/runtime/elastic.py`` (pure Python); the
supervisor drives the port's ``PipelinedScheduler``.

Single-process CPU cannot host real multi-host failures, so this module
implements the CONTROL LOGIC — the piece that is actually subtle — and
the tests drive it with simulated host populations:

* **ElasticPlan**: given surviving hosts, choose the largest runnable
  mesh (keeping the model axis intact, shrinking the data axis), the
  batch re-split, and which checkpoint shards each survivor re-reads.
  Re-mesh is always checkpoint-restore-shaped: state is saved sharded,
  restored under the new mesh's shardings.
* **StragglerPolicy**: deterministic data sharding (``data/pipeline.py``) makes a
  shard a pure function of (step, host), so a slow/dead host's shard can
  be *backfilled* by a designated buddy (skip-and-backfill), or skipped
  entirely (batch shrinks for that step) — both without coordination
  beyond the failure signal.
* **HealthMonitor**: heartbeat bookkeeping with configurable timeout;
  in production the heartbeats come from the coordinator service, in
  tests from the simulator.
* **ElasticSupervisor**: the wiring into the SERVING stack — heartbeat
  state drives ``PipelinedScheduler.set_capacity``/``drain``.  A host
  loss shrinks serving capacity proportionally (excess streams park
  mid-generation and resume when hosts return) instead of dropping
  live streams; losing every host drains the scheduler.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.runtime.faults import InjectedFault, fault_point


@dataclass(frozen=True)
class ElasticPlan:
    data_parallel: int            # new data-axis size
    model_parallel: int           # unchanged (weights must still fit)
    active_hosts: tuple[int, ...]
    batch_per_host: int
    shard_assignment: dict        # host -> checkpoint shard index to read

    @property
    def world_size(self) -> int:
        return self.data_parallel * self.model_parallel


def plan_remesh(all_hosts: int, alive: list[int], *, model_parallel: int,
                global_batch: int, devices_per_host: int = 4) -> ElasticPlan:
    """Choose the largest power-of-two data axis the survivors support.

    The model axis is sacred (params are TP-sharded across it); the data
    axis shrinks to the largest size that (a) the surviving device count
    supports and (b) divides the global batch.
    """
    alive = sorted(alive)
    total_devices = len(alive) * devices_per_host
    if total_devices < model_parallel:
        raise RuntimeError(
            f"cannot remesh: {total_devices} devices < model axis "
            f"{model_parallel}")
    max_dp = total_devices // model_parallel
    dp = 1
    while dp * 2 <= max_dp and global_batch % (dp * 2) == 0:
        dp *= 2
    used_hosts = alive[: (dp * model_parallel) // devices_per_host or 1]
    # survivors adopt the shard indices of the hosts they replace so the
    # deterministic data stream and checkpoint shards stay consistent
    assignment = {h: i for i, h in enumerate(used_hosts)}
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        active_hosts=tuple(used_hosts),
        batch_per_host=global_batch // max(len(used_hosts), 1),
        shard_assignment=assignment,
    )


@dataclass
class StragglerPolicy:
    """Deadline-based straggler handling with deterministic backfill."""

    deadline_factor: float = 3.0        # x median step time
    min_observations: int = 8
    mode: str = "backfill"              # backfill | skip

    def is_straggler(self, host_times: dict, host: int) -> bool:
        times = sorted(host_times.values())
        if len(times) < self.min_observations:
            return False
        median = times[len(times) // 2]
        return host_times.get(host, 0.0) > self.deadline_factor * median

    def reassign(self, stragglers: list[int], healthy: list[int]) -> dict:
        """host -> extra shard index it must also produce this step.

        Deterministic buddy mapping: straggler i's shard goes to
        healthy[i % len(healthy)] — no negotiation required; every healthy
        host derives the same mapping from the shared failure signal.
        """
        if self.mode == "skip" or not healthy:
            return {}
        return {healthy[i % len(healthy)]: s
                for i, s in enumerate(sorted(stragglers))}


@dataclass
class HealthMonitor:
    timeout_s: float = 60.0
    heartbeats: dict = field(default_factory=dict)

    def beat(self, host: int, now: float | None = None):
        self.heartbeats[host] = time.monotonic() if now is None else now

    def alive(self, hosts: list[int], now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h in hosts
                if now - self.heartbeats.get(h, -1e18) <= self.timeout_s]

    def dead(self, hosts: list[int], now: float | None = None) -> list[int]:
        a = set(self.alive(hosts, now))
        return [h for h in hosts if h not in a]


class ElasticSupervisor:
    """Wires heartbeat health into the serving scheduler's capacity.

    ``beat(host)`` feeds the :class:`HealthMonitor` (through the
    ``"heartbeat"`` fault-injection site, so chaos tests can drop beats
    deterministically: an injected fault at the site IS a lost beat,
    not an error).  ``poll()`` recomputes the alive set; when it
    changes, capacity scales with the surviving fraction —
    ``ceil(slots * alive / hosts)`` concurrent slots via
    ``scheduler.set_capacity`` (excess streams park, preserved
    mid-generation) — and losing EVERY host drains the scheduler
    (capacity 0 + ``drain``; recovery undrains).  When ``model_parallel``
    is set, a survivor set too small to host the model axis
    (``plan_remesh`` raising) also maps to a full drain: without a
    runnable mesh there is no engine to serve on.

    Single-process serving has exactly one real host; the simulated
    host population exists so capacity policy (the subtle part) is
    exercised by tests the way a real coordinator would drive it.
    """

    def __init__(self, scheduler, *, hosts: int, monitor: HealthMonitor
                 | None = None, model_parallel: int | None = None,
                 devices_per_host: int = 4, clock=time.monotonic):
        if hosts < 1:
            raise ValueError(f"need at least one host, got {hosts}")
        self.scheduler = scheduler
        self.hosts = list(range(hosts))
        self.monitor = monitor if monitor is not None else HealthMonitor()
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self._clock = clock
        self._alive: tuple[int, ...] = tuple(self.hosts)
        self.events: list[dict] = []
        # every host starts alive at construction time
        now = self._clock()
        for h in self.hosts:
            self.monitor.beat(h, now)

    def beat(self, host: int, now: float | None = None) -> bool:
        """One heartbeat from ``host``; returns False when the beat was
        LOST (injected at the "heartbeat" site) — the monitor then ages
        the host toward its timeout exactly as a real silent host
        would."""
        try:
            fault_point("heartbeat", host=host)
        except InjectedFault:
            return False
        self.monitor.beat(host, self._clock() if now is None else now)
        return True

    def poll(self, now: float | None = None) -> dict | None:
        """Recompute the alive set; on change, re-plan capacity and
        apply it to the scheduler.  Returns the event record (also
        appended to ``events``) or None when nothing changed."""
        now = self._clock() if now is None else now
        alive = tuple(self.monitor.alive(self.hosts, now))
        if alive == self._alive:
            return None
        prev, self._alive = self._alive, alive
        sched = self.scheduler
        slots = sched.engine.slots
        if not alive:
            capacity = 0
        elif self.model_parallel is not None:
            try:
                plan_remesh(len(self.hosts), list(alive),
                            model_parallel=self.model_parallel,
                            global_batch=max(slots, 1),
                            devices_per_host=self.devices_per_host)
                capacity = -(-slots * len(alive) // len(self.hosts))
            except RuntimeError:
                capacity = 0      # survivors can't host the model axis
        else:
            capacity = -(-slots * len(alive) // len(self.hosts))
        if capacity == 0:
            sched.set_capacity(0)
            sched.drain()
        else:
            sched.undrain()
            sched.set_capacity(capacity)
        event = {"prev": prev, "alive": alive, "capacity": capacity,
                 "drained": capacity == 0}
        self.events.append(event)
        return event
