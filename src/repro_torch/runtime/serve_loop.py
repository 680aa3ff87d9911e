"""Serving: the one-shot ``generate`` path and the continuous-batching
engine over the paged KV pool, dense rows or a sliding-window ring (port
of ``repro/runtime/serve_loop.py``).

``generate`` (reference :104) prefills a [B, S0] left-padded batch
(``prompt_lens``; ``prefill="batched"`` through ``Model.prefill``,
chunked past ``prefill_chunk`` or the ring's width, or "sequential"
decode steps) and then decodes ``steps`` tokens a row with the batched
sampler, one generator a row seeded from ``(seed, row)``; rows that hit
``eos_id`` emit ``pad_id`` after it, and the loop stops once every row
has.  ``make_prefill_step`` / ``make_serve_step`` are its two steps as
plain functions (the reference jits them).

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

The dense backend (``cache_kind="dense"``, reference :406-452) keeps
[slots, max_len] rows per layer: admission prefills zeroed single-slot
rows and splices them in (``DenseCache.admit``), and there is no page
accounting.  "auto" stays paged, but for sliding-window models, which
serve on the ring (``cache_kind="ring"``): W = min(max_len, window) rows
a slot with positions absolute, admitted and refilled like the dense
rows (``RingCache`` shares their slot protocol), a prompt longer than W
prefilled in chunks of at most W rows; its decode tick reads the ring in
place through the paged kernel's ring form.  Parking and speculative decoding
refuse the ring, as in the reference.

Speculative decoding (``draft_model``, reference :558-643 and
:1058-1120): the drafter keeps its own dense cache, prefilled beside the
target's at admission (the whole prompt, tail-padded, on the prefix
route).  Each tick the drafter runs K+1 greedy decode steps, the target
verifies the K+1 tokens in ONE ``verify_step`` burst, and each slot
emits its accepted drafts plus one token of its own (``sampling.
spec_verify``; ``greedy_verify`` at temperature 0); rollback is the
``pos`` push to both caches.  Pages for the burst are mapped, and
copy-on-write cleared, up front (``_map_tick_pages(span)``), from a
reservation ``spec_k`` positions larger.  In "match" mode the emitted
streams equal plain decode's at every temperature.

Fault tolerance and elastic capacity (reference :1129-1312): ``snapshot``
/ ``restore`` capture and roll back one tick boundary (every pool tensor
cloned and copied back in place, each slot's generator state, the host
mirrors, the allocator and the prefix cache), and ``park_slot`` /
``resume_parked`` suspend a paged stream mid-generation with its pages
resident and continue it bit for bit.  The reference's fault points
(``runtime/faults.py``) sit at the same sites: ``"prefill.dispatch"``
and ``"sampler"`` of an admission, ``"decode.dispatch"`` and
``"sampler"`` of a tick, ``"spec.verify"`` of a spec tick.  A pipelined
scheduler widens every reservation by its depth (``_reserve_slack``).

The tick uploads its host arrays (block table, tokens, positions) with
:func:`repro_torch.device.upload`, a pinned non-blocking copy, so that
dispatching a tick never waits for the one before it.

SSM and hybrid models serve on every backend (their SSM layers keep an
``SSMCache`` a layer, admitted and restored like the dense rows; the
paged accounting covers their attention layers, none for an SSM-only
model), with prefix caching off ("auto" resolves to off, True raises).
A speculative tick rolls an SSM layer back by selecting its state after
the accepted tokens: the target's from the verify burst's per-step
states, the drafter's from a snapshot after each of its decode steps
(reference :604-640, :1085-1095); an SSM drafter's shadow prefill on
the prefix route stays unpadded (:929-935), so that its state ends on the
prompt's last token.  Parking refuses SSM layers: the reference's parked
record keeps pages only, and the next occupant of the slot overwrites an
SSM layer's state (the reference's parked stream then differs from the
unparked one).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.models import kv_cache
from repro_torch.models.kv_cache import SSMCache
from repro_torch.models.transformer import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.faults import InjectedFault, fault_point
from repro_torch.runtime.page_allocator import PageAllocator
from repro_torch.runtime.prefix_cache import PrefixCache


def _has_ssm(model: Model) -> bool:
    return any(m == "ssm" for m, _ in model.cfg.group)


def _check_spec(model: Model, draft: Model, cache_kind: str, spec_k: int,
                spec_mode: str) -> None:
    """The reference's guards on a speculative pair (ValueError)."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if spec_mode not in ("match", "rejection"):
        raise ValueError(f"unknown spec_mode {spec_mode!r}")
    if cache_kind == "ring":
        raise ValueError(
            "speculative decoding is unsupported on the ring backend: a K-token "
            "verify burst evicts sliding-window rows that rollback cannot restore")
    if draft.cfg.sliding_window:
        raise ValueError(
            "sliding-window drafters are unsupported: rolling the drafter's ring "
            "back past an eviction would resurface overwritten rows as history")
    if draft.cfg.vocab_size != model.cfg.vocab_size:
        raise ValueError(
            f"drafter vocab ({draft.cfg.vocab_size}) != target vocab "
            f"({model.cfg.vocab_size}): speculative pairs must share a tokenizer")


def make_prefill_step(model: Model):
    """(params, batch {"tokens" [B, S] or "embeds" [B, S, D]}) -> the last
    position's logits [B, V] of a cacheless forward (the reference's
    prefill step; serving needs only the next-token head)."""
    def prefill(params, batch):
        out = model.apply(params, batch.get("tokens"), embeds=batch.get("embeds"),
                          last_only=True)
        return out["logits"][:, 0]
    return prefill


def make_serve_step(model: Model):
    """(params, cache, tokens [B]) -> (logits [B, V], cache): one decode
    token (the reference jits it and may donate the cache; here the
    cache is written in place)."""
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return serve_step


def _pad_mask_from_lens(prompt_lens, b: int, s0: int, device=None):
    """[B] real-token counts -> (left-pad mask [B, S0] bool, start [B]
    int32) on ``device``."""
    lens = np.asarray(prompt_lens, np.int64).reshape(-1)
    if lens.shape != (b,):
        raise ValueError(f"prompt_lens must have shape ({b},), got {lens.shape}")
    if (lens < 1).any() or (lens > s0).any():
        raise ValueError(f"prompt_lens must be in [1, {s0}], got {lens}")
    lt = torch.as_tensor(lens, device=device)
    mask = torch.arange(s0, device=device)[None, :] >= (s0 - lt[:, None])
    return mask, (s0 - lt).to(torch.int32)


def generate(model: Model, params, prompt_tokens, steps: int, *,
             temperature: float = 0.0, seed: int = 0, max_len: int | None = None,
             eos_id: int | None = None, pad_id: int = 0, prompt_lens=None,
             prefill: str = "batched", prefill_chunk: int | None = None,
             top_k: int | None = None, top_p: float | None = None,
             cache_kind: str | None = None):
    """Greedy / temperature generation on top of the batched prefill (the
    reference's contract; its ``key`` is ``seed`` here).

    ``prompt_tokens``: [B, S0] ints, LEFT-padded when ragged
    (``prompt_lens`` [B]: real tokens occupy each row's last
    ``prompt_lens[b]`` columns).  Returns [B, steps] int32 on the model's
    device; a row that emits ``eos_id`` emits ``pad_id`` after it, and the
    loop stops once every row has (padded back to ``steps`` columns).

    ``prefill``: "batched" (``Model.prefill``, in chunks of
    ``prefill_chunk`` when set, and of at most the ring's width on a
    sliding-window model) or "sequential" (one decode step a prompt
    token).  ``cache_kind``: "auto" | "dense" | "ring" | "paged" (default
    the config's ``cache_kind``).  Sampling: ``temperature``, ``top_k``
    and ``top_p`` for every row, one ``torch.Generator`` a row seeded
    from ``(seed, row)``; all-greedy steps draw nothing."""
    dev = model.device
    prompt_tokens = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64, device=dev)
    if prompt_tokens.dim() != 2 or 0 in prompt_tokens.shape:
        raise ValueError("prompt_tokens must be [B, S0] with B >= 1 and S0 >= 1 (empty "
                         f"prompts cannot be prefilled); got shape {tuple(prompt_tokens.shape)}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if prefill not in ("batched", "sequential"):
        raise ValueError(f"unknown prefill mode {prefill!r}")
    b, s0 = prompt_tokens.shape
    max_len = max_len or (s0 + steps)
    mask = start = None
    if prompt_lens is not None:
        mask, start = _pad_mask_from_lens(prompt_lens, b, s0, dev)
    cache = model.init_cache(b, max_len, kind=cache_kind or model.cfg.cache_kind)
    if start is not None:
        cache["start"] = start
    step = make_serve_step(model)
    if prefill == "batched":
        logits, cache = model.prefill(params, cache, prompt_tokens, pad_mask=mask,
                                      chunk=prefill_chunk)
    else:
        for t in range(s0):
            logits, cache = model.decode_step(
                params, cache, prompt_tokens[:, t],
                token_mask=None if mask is None else mask[:, t])
    greedy = temperature <= 0 and top_k is None and top_p is None
    if not greedy:
        sampler = sampling.make_sampler(top_k, top_p, pad_id)
        keys = sampling.init_keys(seed, b, dev)
        temp = np.full((b,), temperature, np.float32)
    outs = []
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tok = None
    for _ in range(steps):
        if tok is not None:
            logits, cache = step(params, cache, tok.long())
        tok = sampling.greedy(logits) if greedy else sampler(logits, keys, temp)[0]
        if eos_id is not None:
            tok = torch.where(done, pad_id, tok)
            done = done | (tok == eos_id)
        outs.append(tok)
        if eos_id is not None and bool(done.all()):
            break
    out = torch.stack(outs, dim=1).to(torch.int32)
    if out.shape[1] < steps:   # early EOS stop: keep the [B, steps] contract
        out = torch.nn.functional.pad(out, (0, steps - out.shape[1]), value=pad_id)
    return out


def _prefill_slot(model: Model, params, cache, slot: int, toks, mask, chunk):
    """Prefill ``toks`` [1, S] from position 0 into ``slot`` of ``cache``
    (every layer's ``prefill_view``, then ``admit``: a write-through for
    paged pools, a row splice for dense rows); returns the last token's
    logits."""
    view = {"layers": [c.prefill_view(slot) for c in cache["layers"]], "pos": 0}
    logits, out = model.prefill(params, view, toks, pad_mask=mask, chunk=chunk)
    for c, one in zip(cache["layers"], out["layers"]):
        c.admit(one, slot)
    return logits


def _set_slot(cache: dict, slot: int, pos: int, start: int) -> None:
    """Set one slot's device ``pos`` / ``start`` in place with ``fill_``: a
    scalar setitem would stage the value through pageable host memory and
    sync the stream."""
    cache["pos"][slot].fill_(pos)
    cache["start"][slot].fill_(start)


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


@dataclass
class _Parked:
    """A stream suspended mid-generation: what resuming it bit for bit in
    any free slot needs.  Its page references move from the slot to this
    record, so the pool keeps the KV resident and ``check_leaks`` counts
    the record as a holder."""

    req: Request
    emitted: list[int]
    pos: int
    start: int
    temp: float
    key: torch.Tensor            # the slot generator's state (get_state)
    next_tok: int
    table_row: np.ndarray
    pages: list[int]
    shared: list[int]
    reserved: int


@dataclass
class EngineSnapshot:
    """One tick boundary of a :class:`ServeEngine`.

    The pools are written in place, so every pool tensor is CLONED (K, V
    and the int8 scale pools of each layer, the drafter's dense rows,
    ``pos`` / ``start``); each slot's generator state is captured with
    ``get_state``; host mirrors, allocator refcounts and prefix-cache
    pins are copied, so a rollback unwinds a failed tick's partial
    mutations exactly.  ``restore`` copies back, so one snapshot restores
    any number of times."""

    cache: dict
    dcache: dict | None
    keys: list                   # per-slot generator states
    pos: np.ndarray
    start: np.ndarray
    temp: np.ndarray
    next_tok: np.ndarray
    free: list
    queue: list
    active: dict                 # slot -> (req, emitted copy)
    results: dict
    parked: dict                 # uid -> _Parked (emitted copied)
    next_uid: int
    spec_stats: dict
    cow_copies: int
    table: np.ndarray | None = None
    slot_pages: dict | None = None
    slot_shared: dict | None = None
    slot_reserved: dict | None = None
    alloc: tuple | None = None
    prefix: tuple | None = None

    @property
    def nbytes(self) -> int:
        """Device bytes the snapshot holds (pools, scales, pos / start)."""
        total = 0
        for c in (self.cache, self.dcache):
            if c is not None:
                total += sum(lc.nbytes for lc in c["layers"])
                total += sum(c[k].numel() * c[k].element_size() for k in ("pos", "start"))
        return total


class ServeEngine:
    """Fixed-slot continuous-batching engine on the paged (default), dense
    or ring (sliding-window models' default) backend, with optional
    speculative decoding.

    ``pages`` caps the paged pool (default: slots * ceil(max_len /
    page_size)); an undersized pool stalls admission instead of failing a
    request in flight.  ``on_token(uid, token, done)`` streams tokens as
    sampled.  ``draft_model`` / ``draft_params`` turn speculative decoding
    on with ``spec_k`` drafts a tick, ``spec_mode`` "match" (streams equal
    plain decode's) or "rejection".
    """

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 128, eos_id: int | None = None,
                 pad_id: int = 0, prefill_bucket: int = 8, seed: int = 0,
                 prefill_chunk: int | None = None, top_k: int | None = None,
                 top_p: float | None = None, on_token=None,
                 cache_kind: str | None = None, page_size: int | None = None,
                 pages: int | None = None, draft_model: Model | None = None,
                 draft_params=None, spec_k: int = 4, spec_mode: str = "match",
                 prefix_cache: bool | str = "auto"):
        if slots < 1:
            raise ValueError(f"ServeEngine needs at least one slot, got {slots}")
        if cache_kind in (None, "auto"):
            cache_kind = "ring" if model.cfg.sliding_window else "paged"
        self._spec = draft_model is not None
        if self._spec:
            _check_spec(model, draft_model, cache_kind, spec_k, spec_mode)
        has_ssm = _has_ssm(model)
        if prefix_cache == "auto":
            prefix_cache = cache_kind == "paged" and not has_ssm
        if prefix_cache and has_ssm:
            raise ValueError(
                "prefix caching shares attention KV pages only; SSM layers "
                "carry recurrent state the cache cannot resume from: serve "
                "hybrid/SSM models with prefix_cache=False")
        if prefix_cache and cache_kind != "paged":
            raise ValueError(
                f"prefix caching requires the paged backend, not {cache_kind!r}: "
                "only block tables can map one page into many slots")
        if cache_kind not in ("paged", "dense", "ring"):
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        self.cache_kind = cache_kind
        self.model, self.params = model, params
        self.device = model.device
        self.slots, self.max_len = slots, max_len
        self.eos_id, self.pad_id = eos_id, pad_id
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk
        self.on_token = on_token
        self.seed = seed
        # speculative decoding (set before the page accounting: the
        # reservation counts spec_k)
        self.spec_k, self.spec_mode = spec_k, spec_mode
        self.spec_enabled = True     # off: plain decode ticks, same streams in "match"
        self.spec_stats = {"ticks": 0, "drafted": 0, "accepted": 0, "emitted": 0}
        self._slot_pages: dict[int, list[int]] = {}    # exclusive refs
        self._slot_shared: dict[int, list[int]] = {}   # prefix-shared refs
        self._slot_reserved: dict[int, int] = {}
        self._prefix = None
        self._cow_copies = 0
        if cache_kind == "paged":
            self.page_size = page_size or kv_cache.DEFAULT_PAGE_SIZE
            self._pps = -(-max_len // self.page_size)   # pages per slot
            self._npages = self._pps * slots if pages is None else pages
            cache = model.init_cache(slots, max_len, kind="paged",
                                     page_size=self.page_size,
                                     pages=self._npages, mapped=False)
            # host-side page accounting: refcounted allocator + block-table
            # mirror + per-slot page lists, so ticks never read device state
            self._alloc = PageAllocator(self._npages)
            if prefix_cache:
                self._prefix = PrefixCache(self.page_size, self._alloc)
            self._table = np.zeros((slots, self._pps), np.int32)
        else:   # dense rows, or the ring of a sliding-window model
            cache = model.init_cache(slots, max_len, kind=cache_kind)
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
        self._parked: dict[int, _Parked] = {}
        # positions a pipelined scheduler's dispatch-ahead ticks may write
        # past prompt + max_new before the host learns a request finished
        # (PipelinedScheduler sets it to its depth)
        self._reserve_slack = 0
        if not self._spec:
            return
        self.draft_model, self.draft_params = draft_model, draft_params
        dcache = draft_model.init_cache(slots, max_len, kind="dense")
        dcache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        dcache["start"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self._dcache = dcache
        self._verifier = sampling.make_spec_verifier(top_k, top_p, spec_mode)
        self._t_has_ssm, self._d_has_ssm = _has_ssm(model), _has_ssm(draft_model)

    @property
    def _paged(self) -> bool:
        return self.cache_kind == "paged"

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
        need = self._pages_needed(sp, max_new_tokens) if self._paged else 0
        if self._paged and need > self._npages:
            raise ValueError(f"request needs {need} pages worst-case but the "
                             f"pool only has {self._npages}; raise pages= or "
                             "page_size=")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid, tokens, max_new_tokens, temperature))
        return uid

    # .. internals ..
    def _push_table(self) -> None:
        """Adopt the host block-table mirror in every layer (one
        non-blocking upload)."""
        table = upload(self._table, self.device)
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
        _set_slot(self.cache, slot, 0, 0)
        self._pos[slot] = 0
        self._start[slot] = 0
        self._temp[slot] = 0.0
        self._next_tok[slot] = self.pad_id
        if self._spec:
            _set_slot(self._dcache, slot, 0, 0)
        if not self._paged:
            for c in self.cache["layers"]:
                c.free_slot(slot)
            return
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
        [0, prompt + max_new), plus ``spec_k`` speculative positions (a
        verify burst writes that far past the last committed token), plus
        a pipelined scheduler's ``_reserve_slack`` (dispatch-ahead ticks
        overshoot the same way), capped at the per-slot table length."""
        extra = (self.spec_k if self._spec else 0) + self._reserve_slack
        return min(-(-(prompt_len + max_new + extra) // self.page_size), self._pps)

    @property
    def pool_bytes(self) -> int:
        """Bytes of every layer's K/V pools (or rows) and int8-KV scales, and
        of its SSM states (``ssm_bytes``)."""
        return sum(c.nbytes for c in self.cache["layers"])

    @property
    def ssm_bytes(self) -> int:
        """Bytes of the SSM layers' states (conv windows and SSD states)."""
        return sum(c.nbytes for c in self.cache["layers"] if isinstance(c, SSMCache))

    @property
    def page_stats(self) -> dict | None:
        """{total, free, shared, resident, reserved, cached (prefix-cache
        pins, when enabled)} pool accounting; None on the dense backend."""
        if not self._paged:
            return None
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
        except InjectedFault:
            raise                 # keep the site / uid for recovery
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
            s_t, d_t = (upload(t, self.device, np.int64) for t in (src, dst))
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
        toks = upload([[token]], self.device, np.int64)
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
        pages (or into its dense rows).  A drafter prefills the same prompt
        into its own dense rows."""
        fault_point("prefill.dispatch", uid=req.uid)
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
                toks = upload([req.tokens[pos0:] + [self.pad_id] * (spb - real)], dev,
                              np.int64)
                logits = self._prefill_suffix(toks, layers, pos0, real)
            # the full prompt pages join the cache (already cached blocks keep
            # their pages)
            self._prefix.insert(req.tokens,
                                [int(p) for p in self._table[slot, :n // self.page_size]])
            # the drafter shadow-prefills the whole prompt, tail-padded; an
            # SSM drafter's state must end on the last real token: unpadded
            spd = (n if self._spec and self._d_has_ssm
                   else min(_bucket(n, self.prefill_bucket), self.max_len))
            dtoks = upload([req.tokens + [self.pad_id] * (spd - n)], dev, np.int64)
            dmask, pos, start = None, n, 0
        else:
            sp = _bucket(n, self.prefill_bucket)
            if self._paged and not self._alloc_pages(
                    slot, -(-sp // self.page_size), self._pages_needed(sp, req.max_new_tokens)):
                return False
            toks = upload([[self.pad_id] * (sp - n) + req.tokens], dev, np.int64)
            mask = torch.arange(sp, device=dev)[None, :] >= (sp - n)
            logits = _prefill_slot(self.model, self.params, self.cache, slot, toks, mask,
                                   self.prefill_chunk)
            dtoks, dmask, pos, start = toks, mask, sp, sp - n
        _set_slot(self.cache, slot, pos, start)
        if self._spec:   # the drafter shadows the prompt's prefill
            _prefill_slot(self.draft_model, self.draft_params, self._dcache, slot, dtoks,
                          dmask, self.prefill_chunk)
            _set_slot(self._dcache, slot, pos, start)
        self._pos[slot] = pos
        self._start[slot] = start
        self._active[slot] = _SlotState(req)
        self._temp[slot] = req.temperature
        # per-request generator: a replay samples the same stream
        # whichever slot (or neighbours) it lands with
        self._keys[slot] = sampling.seed_generator(self.seed, req.uid, dev)
        fault_point("sampler", uid=req.uid)
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

    def _map_tick_pages(self, span: int = 0) -> None:
        """Make positions ``[pos, pos + span]`` of each active slot
        write-safe before a decode tick (span 0) or a verify burst (span
        ``tick_k``): map each still-null page there (grabs from the slot's
        own reservation) and run the copy-on-write gate over the range, so
        no write lands on an unmapped page or on a page another holder maps
        (a rolled-back burst would scribble on a shared prompt).  All of a
        tick's table changes push as one copy.  Nothing to do on dense
        rows."""
        if not self._paged:
            return
        dirty = False
        for slot in self._active:
            p = min(int(self._pos[slot]), self.max_len - 1)
            hi = min(p + span, self.max_len - 1)
            for pp in range(p // self.page_size,
                            min(hi // self.page_size, self._pps - 1) + 1):
                if self._table[slot, pp] == 0:
                    pid = self._take_pages(1)[0]
                    self._slot_pages[slot].append(pid)
                    self._table[slot, pp] = pid
                    dirty = True
            if self._prefix is not None:
                dirty |= self._cow(slot, p, hi)
        if dirty:
            self._push_table()

    # .. driving ..
    def step(self) -> bool:
        """Admit newcomers, then one batched decode tick + one batched
        sample for every slot, or with a drafter one speculative tick
        (``_spec_tick``).  Returns True while work remains."""
        self._admit()
        if not self._active:
            return bool(self._queue)
        if self._spec and self.spec_enabled:
            return self._spec_tick()
        fault_point("decode.dispatch")
        self._map_tick_pages()
        toks_in = upload(self._next_tok, self.device, np.int64)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    toks_in)
        self._pos += 1     # decode_step advances every slot's pos
        if self._spec:
            # spec degraded to plain ticks: keep the drafter's pos in step
            # (its missing rows only cost acceptance, never correctness)
            self._dcache["pos"] = self._pos_tensor()
        fault_point("sampler")
        if self._temp.any() or self._truncates:
            toks, _ = self._sampler(logits, self._keys, self._temp)
        else:              # all-greedy tick: no Gumbel draw
            toks = sampling.greedy(logits)
        toks = toks.cpu().numpy()          # the ONE device->host transfer
        for slot in list(self._active):
            self._emit(slot, int(toks[slot]))
        return bool(self._active or self._queue)

    def _pos_tensor(self):
        return upload(self._pos, self.device, np.int32)

    def _spec_tick(self) -> bool:
        """One speculative tick: K+1 greedy drafter decode steps, ONE
        verify burst through the target, then each slot emits its accepted
        drafts and one token of its own, and ``pos`` rolls both caches back
        to what was emitted."""
        fault_point("spec.verify")
        active = list(self._active)
        # the burst writes pos .. pos + tick_k, inside max_len for every
        # slot (slots free at max_len - 1, so tick_k >= 1)
        tick_k = min(self.spec_k, self.max_len - 1 - max(int(self._pos[s]) for s in active))
        self._map_tick_pages(tick_k)
        tok0 = upload(self._next_tok, self.device, np.int64)
        dc, tok, drafts, snaps = dict(self._dcache), tok0, [], []
        for _ in range(tick_k + 1):   # the last step writes the last draft's row
            logits, dc = self.draft_model.decode_step(self.draft_params, dc, tok)
            tok = sampling.greedy(logits).long()
            drafts.append(tok)
            if self._d_has_ssm:      # each step's SSM states, for the rollback
                snaps.append([(c.conv, c.ssd) if isinstance(c, SSMCache) else None
                              for c in dc["layers"]])
        drafts = torch.stack(drafts[:tick_k], dim=1)            # [B, K]
        burst = torch.cat([tok0[:, None], drafts], dim=1)       # [B, K+1]
        vlogits, self.cache, states = self.model.verify_step(self.params, self.cache, burst)
        if self._temp.any() or self._truncates:
            toks, n_acc, _ = self._verifier(vlogits, drafts, self._keys, self._temp)
        else:              # all-greedy tick: argmax matching, no generator
            toks, n_acc = sampling.greedy_verify(vlogits, drafts)
        # SSM rollback: each layer's state after the accepted tokens
        if self._t_has_ssm:
            self.model.select_ssm_states(self.cache["layers"], states, n_acc)
        if self._d_has_ssm:
            stacked = [None if per is None else SSMCache(
                torch.stack([s[i][0] for s in snaps], dim=1),
                torch.stack([s[i][1] for s in snaps], dim=1))
                for i, per in enumerate(snaps[0])]
            self.draft_model.select_ssm_states(self._dcache["layers"], stacked, n_acc)
        toks_h, acc_h = toks.cpu().numpy(), n_acc.cpu().numpy()   # the only pulls
        self.spec_stats["ticks"] += 1
        for slot in active:
            a = int(acc_h[slot])
            self.spec_stats["drafted"] += tick_k
            self.spec_stats["accepted"] += a
            # the accepted drafts + the free token, the pos mirror advancing
            # per token so EOS / max_new / max_len stop where plain decode does
            for j in range(a + 1):
                self._pos[slot] += 1
                self.spec_stats["emitted"] += 1
                if self._emit(slot, int(toks_h[slot, j])):
                    break
        # the rollback: rejected rows sit past every slot's committed depth,
        # masked until overwritten (freed slots' mirrors are zero)
        self.cache["pos"] = self._pos_tensor()
        self._dcache["pos"] = self._pos_tensor()
        return bool(self._active or self._queue)

    @property
    def acceptance_rate(self) -> float | None:
        """Fraction of drafted tokens accepted (None before a spec tick)."""
        d = self.spec_stats["drafted"]
        return None if d == 0 else self.spec_stats["accepted"] / d

    # .. snapshot / restore (the fault-tolerance rollback boundary) ..
    @staticmethod
    def _clone_cache(cache: dict) -> dict:
        """Deep copy of a cache dict: every layer's tensors and pos / start."""
        out = dict(cache)
        out["layers"] = [c.clone() for c in cache["layers"]]
        out["pos"] = cache["pos"].clone()
        out["start"] = cache["start"].clone()
        return out

    @staticmethod
    def _restore_cache(cache: dict, snap: dict) -> None:
        """Copy ``snap``'s tensors back into ``cache``'s pools in place (the
        tensors every layer, view and table refer to stay the same)."""
        for c, sc in zip(cache["layers"], snap["layers"]):
            c.copy_from(sc)
        cache["pos"] = snap["pos"].clone()
        cache["start"] = snap["start"].clone()

    def _generator(self, state) -> torch.Generator:
        """A fresh generator on the engine's device in ``state``."""
        g = torch.Generator(device=self.device)
        g.set_state(state)
        return g

    @staticmethod
    def _copy_parked(parked: dict) -> dict:
        return {u: replace(rec, emitted=list(rec.emitted), pages=list(rec.pages),
                           shared=list(rec.shared), table_row=rec.table_row.copy())
                for u, rec in parked.items()}

    def snapshot(self) -> EngineSnapshot:
        """Capture one tick boundary (see :class:`EngineSnapshot`).  Call it
        between ticks only: one taken mid-tick would mix pre- and post-tick
        state."""
        snap = EngineSnapshot(
            cache=self._clone_cache(self.cache),
            dcache=self._clone_cache(self._dcache) if self._spec else None,
            keys=[g.get_state() for g in self._keys],
            pos=self._pos.copy(), start=self._start.copy(), temp=self._temp.copy(),
            next_tok=self._next_tok.copy(), free=list(self._free), queue=list(self._queue),
            active={s: (st.req, list(st.emitted)) for s, st in self._active.items()},
            results={u: list(v) for u, v in self._results.items()},
            parked=self._copy_parked(self._parked), next_uid=self._next_uid,
            spec_stats=dict(self.spec_stats), cow_copies=self._cow_copies)
        if self._paged:
            snap.table = self._table.copy()
            snap.slot_pages = {s: list(v) for s, v in self._slot_pages.items()}
            snap.slot_shared = {s: list(v) for s, v in self._slot_shared.items()}
            snap.slot_reserved = dict(self._slot_reserved)
            snap.alloc = self._alloc.snapshot()
            if self._prefix is not None:
                snap.prefix = self._prefix.snapshot()
        return snap

    def restore(self, snap: EngineSnapshot) -> None:
        """Roll the engine back to ``snap``: pools copied back in place (each
        layer adopting a copy of its captured block table), every slot's
        generator rebuilt in its captured state.  Everything is copied on
        the way in, so one snapshot restores any number of times;
        ``check_leaks`` passes right after (restore unwinds the partial
        allocations, pins and table updates of a failed tick)."""
        self._restore_cache(self.cache, snap.cache)
        if self._spec:
            self._restore_cache(self._dcache, snap.dcache)
        self._keys = [self._generator(st) for st in snap.keys]
        self._pos = snap.pos.copy()
        self._start = snap.start.copy()
        self._temp = snap.temp.copy()
        self._next_tok = snap.next_tok.copy()
        self._free = list(snap.free)
        self._queue = deque(snap.queue)
        self._active = {s: _SlotState(req, list(em)) for s, (req, em) in snap.active.items()}
        self._results = {u: list(v) for u, v in snap.results.items()}
        self._parked = self._copy_parked(snap.parked)
        self._next_uid = snap.next_uid
        self.spec_stats = dict(snap.spec_stats)
        self._cow_copies = snap.cow_copies
        if self._paged:
            self._table = snap.table.copy()
            self._slot_pages = {s: list(v) for s, v in snap.slot_pages.items()}
            self._slot_shared = {s: list(v) for s, v in snap.slot_shared.items()}
            self._slot_reserved = dict(snap.slot_reserved)
            self._alloc.restore(snap.alloc)
            if self._prefix is not None:
                self._prefix.restore(snap.prefix)

    # .. park / resume (the elastic-capacity boundary) ..
    def park_slot(self, slot: int) -> int:
        """Suspend the stream in ``slot`` mid-generation: its pages (and
        their KV) stay resident under a :class:`_Parked` record while the
        slot frees for other work; ``resume_parked`` continues the stream
        bit for bit.  Paged backend only, and not with a drafter.  Returns
        the parked request's uid."""
        if not self._paged:
            raise ValueError(
                "parking requires the paged backend: dense / ring slots reuse the "
                "parked stream's KV rows for the next occupant")
        if self._spec:
            raise ValueError(
                "parking speculative engines is unsupported: the drafter's dense "
                "cache rows cannot survive slot reuse")
        if _has_ssm(self.model):
            raise ValueError(
                "parking SSM / hybrid engines is unsupported: an SSM layer's state "
                "sits in the slot's rows, which the next occupant overwrites (the "
                "parked record keeps pages only)")
        st = self._active.pop(slot)
        uid = st.req.uid
        self._parked[uid] = _Parked(
            req=st.req, emitted=st.emitted, pos=int(self._pos[slot]),
            start=int(self._start[slot]), temp=float(self._temp[slot]),
            key=self._keys[slot].get_state(), next_tok=int(self._next_tok[slot]),
            table_row=self._table[slot].copy(), pages=self._slot_pages.pop(slot, []),
            shared=self._slot_shared.pop(slot, []),
            reserved=self._slot_reserved.pop(slot, 0))
        self._free.append(slot)
        self._pos[slot] = 0
        self._start[slot] = 0
        self._temp[slot] = 0.0
        self._next_tok[slot] = self.pad_id
        _set_slot(self.cache, slot, 0, 0)
        self._table[slot] = 0
        self._push_table()
        return uid

    def resume_parked(self, uid: int) -> int:
        """Resume a parked stream into a free slot: its block-table row,
        generator state, positions and pending token come back exactly, so
        the continued stream equals one never parked.  Returns the slot;
        raises when no slot is free."""
        rec = self._parked[uid]
        if not self._free:
            raise RuntimeError(f"cannot resume parked request {uid}: no free slot")
        slot = self._free[-1]
        self._free.remove(slot)
        del self._parked[uid]
        self._slot_pages[slot] = rec.pages
        self._slot_shared[slot] = rec.shared
        self._slot_reserved[slot] = rec.reserved
        self._table[slot] = rec.table_row
        self._push_table()
        _set_slot(self.cache, slot, rec.pos, rec.start)
        self._pos[slot] = rec.pos
        self._start[slot] = rec.start
        self._temp[slot] = rec.temp
        self._next_tok[slot] = rec.next_tok
        self._keys[slot] = self._generator(rec.key)
        self._active[slot] = _SlotState(rec.req, rec.emitted)
        return slot

    def drop_parked(self, uid: int) -> None:
        """Abandon a parked stream (cancel or quarantine while parked):
        release every page reference its record holds."""
        rec = self._parked.pop(uid)
        for pid in rec.pages + rec.shared:
            self._alloc.release(pid)

    @property
    def parked_uids(self) -> list[int]:
        return list(self._parked)

    def check_leaks(self) -> None:
        """Allocator leak check: every page's refcount equals its holders
        (block-table occurrences, the prefix cache's pins and parked
        streams' records) and free + resident pages tile the pool.
        Nothing to check on dense rows."""
        if not self._paged:
            return
        occupancy: dict[int, int] = {}
        pins = self._prefix.pages() if self._prefix is not None else []
        parked = [pid for rec in self._parked.values() for pid in rec.pages + rec.shared]
        for pid in self._table.reshape(-1).tolist() + pins + parked:
            if pid:
                occupancy[pid] = occupancy.get(pid, 0) + 1
        self._alloc.check(occupancy)

    def run(self) -> dict[int, list[int]]:
        """Drive until queue and slots drain; returns {uid: tokens}."""
        while self.step():
            pass
        self.check_leaks()
        return dict(self._results)
