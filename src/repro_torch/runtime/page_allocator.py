"""Refcounted page allocator: the host-side half of the paged KV pool.

The port's own copy of ``repro/runtime/page_allocator.py``, with the
``"allocator.alloc"`` fault-injection point in ``alloc``.

``ServeEngine`` used to own a raw free list (``_free_pages``) inline —
correct for exclusive ownership, but structurally unable to express the
many-to-one block-table mappings the paged machinery already permits
(block tables are just indices).  ``PageAllocator``
makes page lifetime first-class so pages can be SHARED:

* ``alloc(n)``  — pop n pages off the free list, each born with
  refcount 1 (exclusive).
* ``share(pid)`` — one more holder of a live page (a prefix-cache pin, a
  second slot mapping the same system-prompt page).  Refcount + 1.
* ``release(pid)`` — one holder lets go.  Refcount - 1; the page returns
  to the free list only at zero.  Releasing a free/unknown page raises:
  a double free would eventually hand the same page to two slots and
  silently cross-contaminate their KV.

Page ids are 1-based — page 0 is the paged backend's null page
(``kv_cache.PagedCache``: unmapped table entries point at it and reads
compute-skip it), so it is never allocated.

``stats()`` snapshots ``{total, free, shared, resident}`` (shared =
pages with refcount > 1; resident = pages with refcount >= 1) and
``check(occupancy)`` is the engine-shutdown leak check: the caller
counts how many holders it can SEE per page (block-table occurrences +
prefix-cache pins) and the allocator asserts its refcounts agree and
that free + resident tile the pool exactly.
"""

from __future__ import annotations

from collections.abc import Mapping

from repro_torch.runtime.faults import fault_point


class PageAllocator:
    """Refcounted allocator over page ids ``1..total`` (0 = null page)."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"page pool needs at least 1 page, got {total}")
        self.total = total
        # popped low-id first (matches the engine's historical order, so
        # page-id-sensitive tests and benches stay deterministic)
        self._free = list(range(total, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def free(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Pop ``n`` fresh pages, each with refcount 1."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        fault_point("allocator.alloc", n=n, free=len(self._free))
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.total}")
        pids = [self._free.pop() for _ in range(n)]
        for pid in pids:
            self._refs[pid] = 1
        return pids

    def share(self, pid: int) -> None:
        """Add a holder to a live page (refcount + 1)."""
        if pid not in self._refs:
            raise ValueError(f"cannot share unmapped page {pid}")
        self._refs[pid] += 1

    def release(self, pid: int) -> None:
        """Drop a holder; the page frees when the last one lets go."""
        count = self._refs.get(pid)
        if count is None:
            raise ValueError(
                f"double free: page {pid} is not mapped (already freed, or "
                "never allocated)")
        if count == 1:
            del self._refs[pid]
            self._free.append(pid)
        else:
            self._refs[pid] = count - 1

    def refcount(self, pid: int) -> int:
        """Current holder count (0 for free/unknown pages)."""
        return self._refs.get(pid, 0)

    def stats(self) -> dict[str, int]:
        """{total, free, shared (refcount > 1), resident (refcount >= 1)}."""
        return {
            "total": self.total,
            "free": len(self._free),
            "shared": sum(1 for c in self._refs.values() if c > 1),
            "resident": len(self._refs),
        }

    def snapshot(self) -> tuple:
        """Full allocator state (free list + refcounts), copied — the
        engine snapshot/rollback boundary captures it so a failed tick's
        partial allocations unwind exactly."""
        return (list(self._free), dict(self._refs))

    def restore(self, snap: tuple) -> None:
        """Adopt a ``snapshot()``; copies, so one snapshot restores any
        number of times."""
        free, refs = snap
        self._free = list(free)
        self._refs = dict(refs)

    def check(self, occupancy: Mapping[int, int]) -> None:
        """Leak check: assert refcounts == the holders the caller can see.

        ``occupancy`` maps page id -> observed holder count (for the
        engine: block-table occurrences plus prefix-cache pins).  Raises
        ``AssertionError`` on any drift — a page both free and mapped, a
        leaked page (neither free nor mapped), or a refcount that
        disagrees with the observed occupancy.
        """
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            dupes = sorted(p for p in free_set if self._free.count(p) > 1)
            raise AssertionError(f"free list holds duplicate pages {dupes}")
        overlap = free_set & self._refs.keys()
        if overlap:
            raise AssertionError(
                f"pages both free and mapped: {sorted(overlap)}")
        if len(self._free) + len(self._refs) != self.total:
            leaked = (set(range(1, self.total + 1)) - free_set
                      - self._refs.keys())
            raise AssertionError(
                f"pages leaked (neither free nor mapped): {sorted(leaked)}")
        occ = {int(p): int(c) for p, c in occupancy.items() if c}
        if occ != self._refs:
            drift = {p: (occ.get(p, 0), self._refs.get(p, 0))
                     for p in occ.keys() | self._refs.keys()
                     if occ.get(p, 0) != self._refs.get(p, 0)}
            raise AssertionError(
                "refcount drift {page: (observed holders, refcount)}: "
                f"{drift}")
