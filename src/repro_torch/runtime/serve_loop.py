"""Continuous-batching serving engine over the paged KV pool (port of
``ServeEngine`` from ``repro/runtime/serve_loop.py``).

Each ``step()`` admits queued requests into free slots, then runs ONE
batched decode step for every slot plus one batched sample; only the
[slots] sampled tokens come back to the host.  Admission (the plain
paged path, ``serve_loop.py:938-980``) left-pads the prompt to a
power-of-two bucket, reserves the request's worst case in pages from the
refcounted :class:`PageAllocator`, maps the prompt's pages into the
slot's block-table row and prefills straight through the pool; decode
maps one reserved page at a time as a slot crosses a page boundary, and
EOS / max_new_tokens releases the slot's pages.  Every quantized
projection runs its matmul kernel (packed EN-T, or w8a8 int8 for
plane-less records), admission prefill the masked flash kernel and the
decode tick the paged decode kernel.  A ``kv_quant``
model serves from int8 pools with bf16 scale pools (``pool_bytes``).

Prefix sharing (``prefix_cache``, "auto" by default: on for the paged
attention-only models the port serves, as in the reference): a radix
cache of full-page prompt prefixes (:class:`PrefixCache`) pins the pages
that hold their KV.  A newcomer maps the longest cached prefix into its
block table (``_map_prefix``), allocates pages for the rest of its prompt
only, and prefills the unshared suffix at absolute positions from start
0, tail-padded to a power-of-two bucket with the real length picking the
logits (``_prefill_suffix``); a fully cached prompt only peeks its last
token's logits read-only (``_peek``).  Its full prompt pages then join
the cache.  Any write into a page another holder still maps is
copy-on-write (``_cow``), and idle cached pages are evicted, LRU, when
the pool runs short.

Not ported in this slice (each raises ``NotImplementedError``):
speculative decoding (``draft_model``) and the dense/ring engine
backends.  ``generate``, the one-shot path of the same reference file,
is a later slice too.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import kv_cache
from repro_torch.models.transformer import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.page_allocator import PageAllocator
from repro_torch.runtime.prefix_cache import PrefixCache


def _bucket(n: int, lo: int) -> int:
    """Round a prompt length up to a power of two (>= lo)."""
    b = max(lo, 1)
    while b < n:
        b *= 2
    return b


@dataclass
class Request:
    """One serving request; ``tokens`` is the raw (unpadded) prompt."""
    uid: int
    tokens: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0


@dataclass
class _SlotState:
    req: Request
    emitted: list[int] = field(default_factory=list)


class ServeEngine:
    """Fixed-slot continuous-batching engine on the paged backend.

    ``pages`` caps the pool (default: slots * ceil(max_len / page_size));
    an undersized pool stalls admission instead of failing a request in
    flight.  ``on_token(uid, token, done)`` streams tokens as sampled.
    """

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 128, eos_id: int | None = None,
                 pad_id: int = 0, prefill_bucket: int = 8, seed: int = 0,
                 prefill_chunk: int | None = None, top_k: int | None = None,
                 top_p: float | None = None, on_token=None,
                 cache_kind: str | None = None, page_size: int | None = None,
                 pages: int | None = None, draft_model: Model | None = None,
                 draft_params=None, prefix_cache: bool | str = "auto"):
        if slots < 1:
            raise ValueError(f"ServeEngine needs at least one slot, got {slots}")
        has_ssm = any(m == "ssm" for m, _ in model.cfg.group)
        if prefix_cache == "auto":
            prefix_cache = not has_ssm
        if prefix_cache and has_ssm:
            raise ValueError(
                "prefix caching shares attention KV pages only; SSM layers "
                "carry recurrent state the cache cannot resume from: serve "
                "hybrid/SSM models with prefix_cache=False")
        if prefix_cache and cache_kind not in (None, "auto", "paged"):
            raise ValueError(
                f"prefix caching requires the paged backend, not {cache_kind!r}: "
                "only block tables can map one page into many slots")
        if cache_kind not in (None, "auto", "paged"):
            raise NotImplementedError(
                f"the {cache_kind!r} engine backend is not ported; this "
                "slice serves the paged backend")
        if model.cfg.sliding_window:
            raise NotImplementedError("sliding-window models serve through "
                                      "the ring backend, not ported yet")
        if draft_model is not None or draft_params is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP: spec decode)")
        del draft_params
        self.cache_kind = "paged"
        self.model, self.params = model, params
        self.device = model.device
        self.slots, self.max_len = slots, max_len
        self.eos_id, self.pad_id = eos_id, pad_id
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk
        self.on_token = on_token
        self.seed = seed
        self.page_size = page_size or kv_cache.DEFAULT_PAGE_SIZE
        self._pps = -(-max_len // self.page_size)   # pages per slot
        self._npages = self._pps * slots if pages is None else pages
        cache = model.init_cache(slots, max_len, kind="paged",
                                 page_size=self.page_size,
                                 pages=self._npages, mapped=False)
        # host-side page accounting: refcounted allocator + block-table
        # mirror + per-slot page lists, so ticks never read device state
        self._alloc = PageAllocator(self._npages)
        self._slot_pages: dict[int, list[int]] = {}    # exclusive refs
        self._slot_shared: dict[int, list[int]] = {}   # prefix-shared refs
        self._slot_reserved: dict[int, int] = {}
        self._prefix = PrefixCache(self.page_size, self._alloc) if prefix_cache else None
        self._cow_copies = 0
        self._table = np.zeros((slots, self._pps), np.int32)
        cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        cache["start"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.cache = cache
        self._sampler = sampling.make_sampler(top_k, top_p, pad_id)
        self._truncates = top_k is not None or top_p is not None
        self._keys = sampling.init_keys(seed, slots, self.device)
        self._temp = np.zeros((slots,), np.float32)
        # host mirrors of cache["pos"] / cache["start"]
        self._pos = np.zeros((slots,), np.int64)
        self._start = np.zeros((slots,), np.int64)
        self._queue: deque[Request] = deque()
        self._free = list(range(slots))
        self._active: dict[int, _SlotState] = {}
        self._next_tok = np.full((slots,), pad_id, np.int32)
        self._results: dict[int, list[int]] = {}
        self._next_uid = 0

    # .. request intake ..
    def submit(self, tokens, *, max_new_tokens: int = 32,
               temperature: float = 0.0) -> int:
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not tokens:
            raise ValueError("cannot serve an empty prompt")
        # prefix-cached admission keeps absolute positions (tail pads never
        # occupy one), so the exact length is the capacity bound
        sp = (len(tokens) if self._prefix is not None
              else _bucket(len(tokens), self.prefill_bucket))
        if sp + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(tokens)} tokens"
                f"{'' if self._prefix is not None else ', bucketed'}) + max_new_tokens "
                f"({max_new_tokens}) exceeds engine max_len {self.max_len}")
        need = self._pages_needed(sp, max_new_tokens)
        if need > self._npages:
            raise ValueError(f"request needs {need} pages worst-case but the "
                             f"pool only has {self._npages}; raise pages= or "
                             "page_size=")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid, tokens, max_new_tokens, temperature))
        return uid

    # .. internals ..
    def _push_table(self) -> None:
        """Adopt the host block-table mirror in every layer (one copy)."""
        table = torch.from_numpy(self._table.copy()).to(self.device)
        for c in self.cache["layers"]:
            c.with_table(table)

    def _release_slot(self, slot: int) -> None:
        """Return ``slot`` to the free list and drop its page references
        (exclusive pages free at once; prefix-shared pages lose one holder,
        the cache's pin keeps them resident).  Records nothing (``_emit``
        stores results first)."""
        self._active.pop(slot, None)
        if slot not in self._free:
            self._free.append(slot)
        self.cache["pos"][slot] = 0
        self.cache["start"][slot] = 0
        self._pos[slot] = 0
        self._start[slot] = 0
        self._temp[slot] = 0.0
        self._next_tok[slot] = self.pad_id
        for pid in self._slot_pages.pop(slot, ()):
            self._alloc.release(pid)
        for pid in self._slot_shared.pop(slot, ()):
            self._alloc.release(pid)
        self._slot_reserved.pop(slot, None)
        self._table[slot] = 0
        self._push_table()

    def cancel(self, uid: int) -> bool:
        """Abort ``uid`` wherever it is (queued or active); no result is
        recorded.  Returns False for unknown or finished uids."""
        for i, req in enumerate(self._queue):
            if req.uid == uid:
                del self._queue[i]
                return True
        for slot, st in list(self._active.items()):
            if st.req.uid == uid:
                self._release_slot(slot)
                return True
        return False

    def _emit(self, slot: int, tok: int) -> bool:
        """Record one sampled token; returns True if the request finished."""
        st = self._active[slot]
        st.emitted.append(tok)
        done = (tok == self.eos_id if self.eos_id is not None else False)
        done = done or len(st.emitted) >= st.req.max_new_tokens
        done = done or int(self._pos[slot]) >= self.max_len - 1
        if self.on_token is not None:
            self.on_token(st.req.uid, tok, done)
        if done:
            self._results[st.req.uid] = st.emitted
            self._release_slot(slot)
        else:
            self._next_tok[slot] = tok
        return done

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages one request can touch: positions
        [0, prompt + max_new), capped at the per-slot table length."""
        return min(-(-(prompt_len + max_new) // self.page_size), self._pps)

    @property
    def pool_bytes(self) -> int:
        """Bytes of every layer's K/V pools and int8-KV scale pools."""
        return sum(c.nbytes for c in self.cache["layers"])

    @property
    def page_stats(self) -> dict:
        """{total, free, shared, resident, reserved, cached (prefix-cache
        pins, when enabled)} pool accounting."""
        stats = self._alloc.stats()
        stats["reserved"] = sum(self._slot_reserved.values())
        if self._prefix is not None:
            stats["cached"] = self._prefix.resident
        return stats

    @property
    def prefix_stats(self) -> dict | None:
        """Prefix-cache counters and the engine's copy-on-write count (None
        when prefix caching is off)."""
        if self._prefix is None:
            return None
        stats = self._prefix.stats()
        stats["cow_copies"] = self._cow_copies
        return stats

    def _pages_available(self) -> int:
        """Pages a new reservation may count on: free pages, plus cached
        pages nobody maps (evictable under pressure), minus the lazily
        mapped rest of live reservations."""
        evictable = self._prefix.evictable if self._prefix is not None else 0
        outstanding = sum(reserved - len(self._slot_pages.get(slot, ()))
                          for slot, reserved in self._slot_reserved.items())
        return self._alloc.free + evictable - outstanding

    def _take_pages(self, n: int) -> list[int]:
        """Allocate ``n`` exclusive pages, evicting idle prefix-cache
        entries to cover a shortfall."""
        if n <= 0:
            return []
        short = n - self._alloc.free
        if short > 0 and self._prefix is not None:
            self._prefix.evict(short)
        try:
            return self._alloc.alloc(n)
        except RuntimeError as e:
            raise RuntimeError("page reservation accounting is broken: pool "
                               "exhausted under a live reservation") from e

    def _cow(self, slot: int, lo: int, hi: int) -> bool:
        """Copy-on-write gate for ``slot`` writing positions [lo, hi]: each
        mapped page there that another holder still maps (refcount > 1) is
        copied to a fresh page and the slot's table remapped BEFORE the
        write, so the other holders' bytes never change.  Returns True when
        the table mirror changed (the caller pushes it with the rest of the
        tick's table updates)."""
        src, dst = [], []
        for pp in range(lo // self.page_size, hi // self.page_size + 1):
            pid = int(self._table[slot, pp])
            if pid == 0 or self._alloc.refcount(pid) <= 1:
                continue
            new = self._take_pages(1)[0]
            src.append(pid)
            dst.append(new)
            self._table[slot, pp] = new
            self._slot_pages[slot].append(new)
            # drop this slot's hold on the shared original (the cache pin or
            # the sibling slots keep it alive)
            if pid in self._slot_shared.get(slot, ()):
                self._slot_shared[slot].remove(pid)
            else:
                self._slot_pages[slot].remove(pid)
            self._alloc.release(pid)
        if src:
            self._cow_copies += len(src)
            s_t, d_t = (torch.tensor(t, dtype=torch.int64, device=self.device)
                        for t in (src, dst))
            for c in self.cache["layers"]:
                c.copy_pages(s_t, d_t)
        return bool(src)

    def _alloc_pages(self, slot: int, need: int, reserve: int) -> bool:
        """Reserve ``reserve`` pages and map the first ``need`` onto
        ``slot``'s table; False when the pool can't cover it yet."""
        if self._pages_available() < reserve:
            return False
        self._slot_reserved[slot] = reserve
        pids = self._take_pages(need)
        self._slot_pages[slot] = pids
        self._table[slot] = 0
        self._table[slot, :need] = pids
        self._push_table()
        return True

    def _map_prefix(self, slot: int, req: Request) -> int | None:
        """Prefix-cached page mapping for ``req``: map the longest cached
        prefix's pages into ``slot``'s block table (one more holder each)
        and allocate fresh pages for the rest of the prompt.  Returns the
        position the prefill resumes at (``len(tokens)``: fully cached,
        admission only peeks), or None when the pool can't cover the
        reservation (admission stalls)."""
        n, ps = len(req.tokens), self.page_size
        matched, spids = self._prefix.match(req.tokens)
        reserve = self._pages_needed(n, req.max_new_tokens) - len(spids)
        # the matched pages are about to be pinned for the slot's lifetime,
        # but _pages_available counts those the cache alone holds as
        # evictable: admitting against that double count would let a later
        # _take_pages under a live reservation find the pool empty with
        # nothing evictable.  Take them out before the check.
        locked = sum(1 for pid in spids if self._alloc.refcount(pid) == 1)
        if self._pages_available() - locked < reserve:
            return None
        for pid in spids:
            self._alloc.share(pid)
        self._slot_shared[slot] = list(spids)
        self._slot_reserved[slot] = reserve
        self._table[slot] = 0
        self._table[slot, :len(spids)] = spids
        prompt_pages = -(-n // ps)
        fresh = self._take_pages(prompt_pages - len(spids))
        self._slot_pages[slot] = fresh
        self._table[slot, len(spids):prompt_pages] = fresh
        self._push_table()
        return matched

    def _prefill_suffix(self, toks, layers, pos0: int, real: int):
        """Prefill the tail-padded suffix ``toks`` [1, bucket] at absolute
        positions from ``pos0`` on top of the mapped prefix, chunk by
        chunk; returns the logits of the last real token (``real`` tokens
        in).  Pad rows write KV past the prompt, where pos-bounded reads
        never look before decode overwrites them (rows past the mapped
        pages land in the null page)."""
        c = {"layers": layers, "pos": pos0}
        sp = toks.shape[1]
        step = min(self.prefill_chunk or sp, sp)
        last, logits = real - 1, None
        for lo in range(0, sp, step):
            hi = min(lo + step, sp)
            here = lo <= last < hi
            out = self.model.apply(self.params, toks[:, lo:hi], cache=c, write_cache=True,
                                   last_only=True, pos0=pos0 + lo, need_logits=here,
                                   last_index=last - lo if here else None)
            c = out["cache"]
            if here:
                logits = out["logits"][:, 0]
        return logits

    def _peek(self, token: int, layers, pos: int):
        """Logits of the last token of a fully cached prompt at ``pos``: a
        read-only forward over the shared pages (no write, so no fresh page
        and no copy-on-write)."""
        toks = torch.tensor([[token]], dtype=torch.int64, device=self.device)
        out = self.model.apply(self.params, toks, cache={"layers": layers, "pos": pos},
                               write_cache=True, peek=True, last_only=True, pos0=pos)
        return out["logits"][:, 0]

    def _admit_one(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into ``slot``; False when the pool can't cover its
        worst case yet.  With the prefix cache: map the cached prefix and
        prefill the suffix unpadded at start 0 (positions, and so RoPE
        rotations, line up across every request sharing the pages), or
        peek a fully cached prompt; then cache its full prompt pages.
        Without: a bucketed left-padded prefill straight through the slot's
        pages."""
        n = len(req.tokens)
        dev = self.device
        if self._prefix is not None:
            pos0 = self._map_prefix(slot, req)
            if pos0 is None:
                return False
            layers = [c.prefill_view(slot) for c in self.cache["layers"]]
            if pos0 >= n:
                logits = self._peek(req.tokens[-1], layers, n - 1)
            else:
                real = n - pos0
                spb = min(_bucket(real, self.prefill_bucket),
                          self._pps * self.page_size - pos0)
                toks = torch.tensor([req.tokens[pos0:] + [self.pad_id] * (spb - real)],
                                    dtype=torch.int64, device=dev)
                logits = self._prefill_suffix(toks, layers, pos0, real)
            # the full prompt pages join the cache (already cached blocks keep
            # their pages)
            self._prefix.insert(req.tokens,
                                [int(p) for p in self._table[slot, :n // self.page_size]])
            pos, start = n, 0
        else:
            sp = _bucket(n, self.prefill_bucket)
            if not self._alloc_pages(slot, -(-sp // self.page_size),
                                     self._pages_needed(sp, req.max_new_tokens)):
                return False
            toks = torch.tensor([[self.pad_id] * (sp - n) + req.tokens],
                                dtype=torch.int64, device=dev)
            mask = torch.arange(sp, device=dev)[None, :] >= (sp - n)
            view = {"layers": [c.prefill_view(slot) for c in self.cache["layers"]],
                    "pos": 0}
            logits, _ = self.model.prefill(self.params, view, toks, pad_mask=mask,
                                           chunk=self.prefill_chunk)
            pos, start = sp, sp - n
        self.cache["pos"][slot] = pos
        self.cache["start"][slot] = start
        self._pos[slot] = pos
        self._start[slot] = start
        self._active[slot] = _SlotState(req)
        self._temp[slot] = req.temperature
        # per-request generator: a replay samples the same stream
        # whichever slot (or neighbours) it lands with
        self._keys[slot] = sampling.seed_generator(self.seed, req.uid, dev)
        tok, _ = self._sampler(logits, self._keys[slot:slot + 1],
                               [req.temperature])
        self._emit(slot, int(tok[0]))
        return True

    def _admit(self):
        while self._queue and self._free:
            req = self._queue[0]
            slot = self._free[-1]
            if not self._admit_one(slot, req):
                break          # pool dry: requests wait for a slot's EOS
            self._queue.popleft()
            self._free.remove(slot)

    def _map_tick_pages(self) -> None:
        """Make each active slot's next write position write-safe before a
        decode tick: map its page if still null (one grab from the slot's
        own reservation) and run the copy-on-write gate over it, so no write
        lands on an unmapped page or on a page another holder maps.  All of
        a tick's table changes push as one copy."""
        dirty = False
        for slot in self._active:
            p = min(int(self._pos[slot]), self.max_len - 1)
            pp = p // self.page_size
            if self._table[slot, pp] == 0:
                pid = self._take_pages(1)[0]
                self._slot_pages[slot].append(pid)
                self._table[slot, pp] = pid
                dirty = True
            if self._prefix is not None:
                dirty |= self._cow(slot, p, p)
        if dirty:
            self._push_table()

    # .. driving ..
    def step(self) -> bool:
        """Admit newcomers, then one batched decode tick + one batched
        sample for every slot.  Returns True while work remains."""
        self._admit()
        if not self._active:
            return bool(self._queue)
        self._map_tick_pages()
        toks_in = torch.from_numpy(self._next_tok.astype(np.int64)).to(self.device)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    toks_in)
        self._pos += 1     # decode_step advances every slot's pos
        if self._temp.any() or self._truncates:
            toks, _ = self._sampler(logits, self._keys, self._temp.tolist())
        else:              # all-greedy tick: no Gumbel draw
            toks = sampling.greedy(logits)
        toks = toks.cpu().numpy()          # the ONE device->host transfer
        for slot in list(self._active):
            self._emit(slot, int(toks[slot]))
        return bool(self._active or self._queue)

    def check_leaks(self) -> None:
        """Allocator leak check: every page's refcount equals its holders
        (block-table occurrences plus the prefix cache's pins) and free +
        resident pages tile the pool."""
        occupancy: dict[int, int] = {}
        pins = self._prefix.pages() if self._prefix is not None else []
        for pid in self._table.reshape(-1).tolist() + pins:
            if pid:
                occupancy[pid] = occupancy.get(pid, 0) + 1
        self._alloc.check(occupancy)

    def run(self) -> dict[int, list[int]]:
        """Drive until queue and slots drain; returns {uid: tokens}."""
        while self.step():
            pass
        self.check_leaks()
        return dict(self._results)
