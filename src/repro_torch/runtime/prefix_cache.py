"""Radix prefix cache: full-page prompt prefixes -> live KV page ids.

The port's own copy of ``repro/runtime/prefix_cache.py`` (pure Python),
over the port's ``runtime/page_allocator.py``.

The million-user serving pattern is thousands of requests sharing a
system prompt.  Their KV for the shared prefix is byte-identical — the
rows depend only on the token ids and their absolute positions (the
engine prefills prefix-cached prompts unpadded at start 0, so positions
line up across requests) — which means the SAME pool pages can back
every one of them through the paged backend's many-to-one block tables.

The cache is a radix trie over page-sized token blocks: each node keys
one full page of prompt tokens (``tuple(tokens[i*page : (i+1)*page])``)
under its parent and holds the id of the pool page storing that block's
KV.  Only FULL pages are cached — a partial tail block is still being
written by its owner and is never shareable.

Refcount pinning (``repro_torch.runtime.page_allocator``): the cache itself
holds ONE reference per cached page (taken at ``insert``), and every
slot that maps a cached page via ``match`` holds its own.  A node is
evictable only while the cache is the page's sole holder (refcount 1),
so ``evict`` can never yank a page out from under a live request.
Eviction is LRU over unpinned LEAF nodes, cascading: freeing a leaf may
expose its parent.  (A pinned descendant implies pinned ancestors — a
slot that shares block k of a prompt shares blocks 0..k — so leaf-first
order never strands an evictable interior node.)

``match`` walks the longest cached prefix of a prompt and returns its
page ids; the engine maps them into the newcomer's block table, shares
each, and prefills only the suffix.  Writes into still-shared pages are
copy-on-write in the engine (see ``ServeEngine._cow``).
"""

from __future__ import annotations

from collections.abc import Sequence

from repro_torch.runtime.page_allocator import PageAllocator


class _Node:
    """One cached full-page block: trie edge label + backing page id."""

    __slots__ = ("block", "page", "parent", "children", "last_used")

    def __init__(self, block, page, parent, clock):
        self.block = block              # tuple[int, ...] of page_size tokens
        self.page = page                # pool page id holding this block's KV
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_used = clock


def _copy(node: _Node, parent: _Node | None) -> _Node:
    """Deep copy of the subtrie under ``node``, hung under ``parent``."""
    n2 = _Node(node.block, node.page, parent, node.last_used)
    for key, child in node.children.items():
        n2.children[key] = _copy(child, n2)
    return n2


class PrefixCache:
    """Trie of full-page prompt blocks pinned in a ``PageAllocator``."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._alloc = allocator
        self._root = _Node((), 0, None, 0)
        self._by_page: dict[int, _Node] = {}   # page id -> node (1:1)
        self._clock = 0
        self.counters = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                         "inserted": 0, "evicted": 0}

    def _blocks(self, tokens: Sequence[int]):
        ps = self.page_size
        full = (len(tokens) // ps) * ps
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, full, ps)]

    # .. lookup / insert ..
    def match(self, tokens: Sequence[int]) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens`` -> (matched_len, page ids).

        ``matched_len`` counts whole pages only.  The caller must
        ``share()`` each returned page before anything (an eviction
        under pool pressure, another admission) could release it — the
        engine does so before its next allocator call.
        """
        self._clock += 1
        self.counters["lookups"] += 1
        node, pids = self._root, []
        for block in self._blocks(tokens):
            child = node.children.get(block)
            if child is None:
                break
            child.last_used = self._clock
            pids.append(child.page)
            node = child
        matched = len(pids) * self.page_size
        if pids:
            self.counters["hits"] += 1
            self.counters["hit_tokens"] += matched
        return matched, pids

    def insert(self, tokens: Sequence[int], pids: Sequence[int]) -> int:
        """Register a prompt's full-page blocks as backed by ``pids``.

        ``pids[i]`` must be the live pool page holding block i's KV
        (the newcomer's block-table prefix).  Blocks already cached are
        only LRU-touched — their existing pages stay canonical; each
        NEWLY cached page gains one allocator reference (the pin).
        Returns the number of nodes added.
        """
        blocks = self._blocks(tokens)
        if len(pids) < len(blocks):
            raise ValueError(
                f"need a page id per full block: {len(blocks)} blocks, "
                f"{len(pids)} page ids")
        self._clock += 1
        node, added = self._root, 0
        for block, pid in zip(blocks, pids):
            child = node.children.get(block)
            if child is None:
                pid = int(pid)
                if pid in self._by_page:
                    raise ValueError(f"page {pid} already caches a block")
                child = _Node(block, pid, node, self._clock)
                node.children[block] = child
                self._by_page[pid] = child
                self._alloc.share(pid)
                added += 1
                self.counters["inserted"] += 1
            else:
                child.last_used = self._clock
            node = child
        return added

    # .. eviction ..
    @property
    def resident(self) -> int:
        """Cached pages currently pinned by this cache."""
        return len(self._by_page)

    @property
    def evictable(self) -> int:
        """Cached pages the cache could free right now (sole holder)."""
        return sum(1 for pid in self._by_page
                   if self._alloc.refcount(pid) == 1)

    def evict(self, n: int) -> int:
        """Free up to ``n`` unpinned pages, LRU leaf first, cascading.

        Returns how many pages actually went back to the pool (< n when
        everything left is pinned by live slots).
        """
        freed = 0
        while freed < n:
            victims = sorted(
                (node for node in self._by_page.values()
                 if not node.children
                 and self._alloc.refcount(node.page) == 1),
                key=lambda node: node.last_used)
            if not victims:
                break
            for node in victims:
                if freed >= n:
                    break
                del node.parent.children[node.block]
                del self._by_page[node.page]
                self._alloc.release(node.page)
                self.counters["evicted"] += 1
                freed += 1
        return freed

    def pages(self) -> list[int]:
        """Every page id the cache currently pins (for leak checks)."""
        return list(self._by_page)

    # .. snapshot / restore (the engine rollback boundary) ..
    def snapshot(self) -> tuple:
        """Deep-copy the trie + counters.  Paired with the allocator's
        snapshot: a failed tick may have inserted/evicted cache entries
        whose pins must unwind with the refcounts they mirror."""
        return (_copy(self._root, None), self._clock, dict(self.counters))

    def restore(self, snap: tuple) -> None:
        """Adopt a ``snapshot()`` (itself re-copied, so one snapshot
        restores any number of times)."""
        root, clock, counters = snap
        self._root = _copy(root, None)
        self._clock = clock
        self.counters = dict(counters)
        self._by_page = {}
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.parent is not None:
                self._by_page[node.page] = node
            stack.extend(node.children.values())

    def stats(self) -> dict[str, float]:
        """Lookup/insert/evict counters + hit rate + residency snapshot."""
        out = dict(self.counters)
        out["resident"] = self.resident
        out["hit_rate"] = (self.counters["hits"] / self.counters["lookups"]
                           if self.counters["lookups"] else 0.0)
        return out
