"""KV-cache backends (port of ``repro/models/kv_cache.py``): the paged
pool the serving engine admits into, the dense rows of the dense engine
backend and of a speculative drafter, and the sliding-window ring of a
windowed model (:class:`RingCache`).

The reference's caches are immutable pytrees: every write returns a new
cache.  Here the writes land IN PLACE (``index_put_`` / slice
assignment into the pool tensors) and the methods return ``self``, so
callers keep the reference's ``new = cache.write_...`` shape without a
pool-sized copy per token.  Nothing keeps an old cache alive across a
write (an engine snapshot ``clone``s every tensor and restores with
``copy_from``; a speculative rollback is a layout operation, see below),
so in-place updates are safe.  A
read-only forward (the
prefix-cache peek) therefore cannot leave the store to dead-code
elimination as the reference does: ``stored`` gives a chunk's rows in
storage form without writing them, and ``PagedCache.detached`` a copy
of a view that the plain path may write instead of the pool.

:class:`PagedCache` keeps per-layer ``[P, page, H, hd]`` pools, page 0
being the reserved null page, plus a ``[B, pages_per_slot]`` int32 block
table; ``token_view`` returns the pool and table as stored
(:class:`PagedView`) for the paged decode kernel.

Speculative decoding: a verify burst writes S rows per sequence at
``pos_b .. pos_b+S-1`` (``write_tokens``, bit for bit S ``write_token``
calls) and reads them back through a position-ordered full-width view
(``verify_view``: the dense rows, or the paged pool gathered) with the
[B, S, W] mask of the S decode ticks it replaces (:func:`burst_valid`).
Rolling rejected drafts back is the engine's ``pos`` reset: the rows past
the accepted position are masked from every later read and rewritten
before their position is reached.  ``fork`` / ``rollback`` snapshot and
restore the paged block table (None / no-op on dense rows).

:class:`DenseCache` also carries the engine's slot protocol:
``prefill_view`` (zeroed single-slot rows), ``admit`` (splice them in at
the slot) and ``free_slot`` (a no-op: stale rows stay masked).

:class:`RingCache` is a :class:`DenseCache` of W = min(max_len, window)
rows per sequence in which position p lives in row p mod W; it inherits
the slot protocol and the snapshot copies, and owns the wrap placement
(:func:`prompt_update`) and the scattered-slot mask (``token_view``).
Its pools are written in place too, so a prefill chunk that wraps
overwrites rows its own earliest queries still attend to: ``context``
gathers the retained rows into a copy, which the caller takes BEFORE the
chunk's write (as every backend's context is taken).  A verify burst over
the ring raises, as in the reference.

:class:`SSMCache` is a Mamba-2 layer's per-slot state (the conv window
and the SSD state), on the same slot protocol as the dense rows.

int8 KV (``quantized=True``): the pools hold int8 codes and every write
quantizes on the way in (:func:`quantize_kv`), with bf16 per-(row, head)
scales in ``[..., H, 1]`` scale pools beside them (``k_s``/``v_s``,
``None`` otherwise).  ``write_prompt`` returns the fresh rows and scales
in storage form, and ``context`` reads the scales back with the rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import ring_valid

DEFAULT_PAGE_SIZE = 16


class PagedView(NamedTuple):
    """In-place decode read: pools as stored plus the block table."""

    k: torch.Tensor                  # [P, page, H, hd] pool
    v: torch.Tensor
    k_s: torch.Tensor | None         # [P, page, H, 1] bf16 int8-KV scales
    v_s: torch.Tensor | None
    block_table: torch.Tensor        # [B, pages_per_slot] int32
    page_size: int


def burst_valid(pos_b, start_b, s: int, w: int):
    """[B, S, W] causal validity of a verify burst over a position-ordered
    width-``w`` view: query t (position ``pos_b + t``) sees columns
    ``start_b .. pos_b + t``, the masks of ``s`` successive decode ticks
    stacked."""
    qpos = pos_b[:, None] + torch.arange(s, dtype=torch.int32, device=pos_b.device)[None, :]
    col = torch.arange(w, dtype=torch.int32, device=pos_b.device)[None, None, :]
    return (col <= qpos[:, :, None]) & (col >= start_b[:, None, None])


def prompt_update(c, new, pos0: int, ring: bool) -> None:
    """Write [B, S, ...] rows at positions ``pos0 .. pos0+S-1`` of ``c``
    [B, W, ...] in place; with ``ring`` position p lands in row p mod W.
    A ring chunk longer than W laps itself: only its last W rows are
    still visible, so the overwritten part is dropped up front (the
    reference's multi-wrap rule)."""
    s, w = new.shape[1], c.shape[1]
    new = new.to(c.dtype)
    if ring and s > w:
        new, pos0, s = new[:, s - w:], pos0 + (s - w), w
    if not ring or pos0 % w + s <= w:
        lo = pos0 % w if ring else pos0
        c[:, lo:lo + s] = new
        return
    idx = torch.remainder(torch.arange(pos0, pos0 + s, device=c.device), w)
    c[:, idx] = new


def quantize_kv(t):
    """[B, S, H, hd] -> (int8 codes, bf16 per-(row, head) scale [B, S, H, 1]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    t32 = t.to(torch.float32)
    amax = t32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


class _KV:
    """The write half shared by the backends: ``_write(put, k, v)``
    quantizes k/v on the way in when the cache is int8 and stores them
    with ``put(pool, rows)``; returns the rows and scales in storage
    form (the operands prefill attends to).  ``window`` is the attention
    window a backend's reads mask (the ring's; None elsewhere)."""

    window = None

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

    def stored(self, k, v):
        """Rows ``k``, ``v`` as ``write_prompt`` would store them (codes and
        scales when int8), written nowhere."""
        return self._write(lambda c, n: None, k, v)

    def _write(self, put, k, v):
        if self.quantized:
            kc, ks = quantize_kv(k)
            vc, vs = quantize_kv(v)
            put(self.k_s, ks)
            put(self.v_s, vs)
        else:
            kc, vc, ks, vs = k.to(self.k.dtype), v.to(self.v.dtype), None, None
        put(self.k, kc)
        put(self.v, vc)
        return kc, vc, ks, vs

    @property
    def nbytes(self) -> int:
        """Bytes of the K/V pools and their scale pools."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_s, self.v_s) if t is not None)

    def fork(self):
        """Checkpoint before a verify burst writes: None for rows, whose
        rollback is the engine's ``pos`` reset alone."""
        return None

    def clone(self):
        """A copy of this cache with every tensor cloned (the engine's
        snapshot)."""
        out = object.__new__(type(self))
        out.__dict__.update({k: v.clone() if torch.is_tensor(v) else v
                             for k, v in vars(self).items()})
        return out

    def copy_from(self, other) -> None:
        """Copy ``other``'s pools and scales (a ``clone`` of this cache)
        back into this cache's tensors in place, and adopt a copy of its
        block table where it has one: every view and table keeps pointing
        at the same pools (the engine's restore)."""
        for name in ("k", "v", "k_s", "v_s"):
            t = getattr(self, name)
            if t is not None:
                t.copy_(getattr(other, name))
        if getattr(other, "block_table", None) is not None:
            self.block_table = other.block_table.clone()

    def rollback(self, snap):
        del snap
        return self


class DenseCache(_KV):
    """Contiguous [B, W, H, hd] rows; slot = absolute position."""

    def __init__(self, k, v, k_s=None, v_s=None):
        self.k, self.v, self.k_s, self.v_s = k, v, k_s, v_s

    @property
    def width(self) -> int:
        return self.k.shape[1]

    def write_token(self, k, v, pos, per_seq: bool):
        """Write one row per sequence at ``pos`` (scalar or [B])."""
        if per_seq:
            rows = torch.arange(k.shape[0], device=k.device)
            at = (rows, pos.long())
        else:
            at = (slice(None), int(pos))

        def put(c, n):
            c[at] = n[:, 0]
        self._write(put, k, v)
        return self

    def write_tokens(self, k, v, pos):
        """Write S rows per sequence at ``pos .. pos+S-1`` (pos [B])."""
        b, s = k.shape[:2]
        rows = torch.arange(b, device=k.device)[:, None]
        cols = pos.long().expand(b)[:, None] + torch.arange(s, device=k.device)[None, :]
        self._write(lambda c, n: c.index_put_((rows, cols), n), k, v)
        return self

    def token_view(self, pos_b, start_b):
        idx = torch.arange(self.width, device=pos_b.device)[None, :]
        valid = (idx <= pos_b[:, None]) & (idx >= start_b[:, None])
        return self.k, self.v, self.k_s, self.v_s, valid

    def verify_view(self, pos_b, start_b, s: int):
        """The rows as stored, with the burst's [B, S, W] mask."""
        return self.k, self.v, self.k_s, self.v_s, burst_valid(pos_b, start_b, s, self.width)

    def write_prompt(self, k, v, pos0: int):
        s = k.shape[1]
        if pos0 + s > self.width:
            raise ValueError(f"prefill chunk [{pos0}, {pos0 + s}) exceeds "
                             f"cache width {self.width}")
        return (self, *self._write(lambda c, n: prompt_update(c, n, pos0, ring=False), k, v))

    def context(self, pos0: int):
        if pos0 == 0:
            return None, None, None, None, 0
        sl = lambda c: None if c is None else c[:, :pos0]   # noqa: E731
        return sl(self.k), sl(self.v), sl(self.k_s), sl(self.v_s), pos0

    # .. engine slot management: rows move ..
    def _leaves(self):
        return self.k, self.v, self.k_s, self.v_s

    def _like(self, k, v, k_s, v_s):
        """A cache of this backend over the given tensors."""
        return DenseCache(k, v, k_s, v_s)

    def prefill_view(self, slot: int):
        """Zeroed single-slot rows for admission prefill."""
        del slot
        return self._like(*(None if t is None else t.new_zeros((1,) + tuple(t.shape[1:]))
                            for t in self._leaves()))

    def admit(self, one, slot: int):
        """Splice the prefilled single-slot rows ``one`` in at ``slot``."""
        for full, new in zip(self._leaves(), one._leaves()):
            if full is not None:
                full[slot] = new[0]
        return self

    def free_slot(self, slot: int):
        """A no-op: a freed slot's rows stay masked by pos / start."""
        del slot
        return self


class RingCache(DenseCache):
    """Sliding-window ring of W = min(max_len, window) rows per sequence;
    position p lives in row p mod W.  ``window`` is the attention window
    the ring's reads mask (``token_view``, and the paged kernel's ring
    form)."""

    def __init__(self, k, v, k_s=None, v_s=None, window: int = 0):
        super().__init__(k, v, k_s, v_s)
        self.window = window

    def _like(self, k, v, k_s, v_s):
        return RingCache(k, v, k_s, v_s, window=self.window)

    def write_token(self, k, v, pos, per_seq: bool):
        """Write one row per sequence at position ``pos`` (scalar or [B]),
        in row ``pos mod W``."""
        w = self.width
        slot = torch.remainder(pos, w) if per_seq else int(pos) % w
        return super().write_token(k, v, slot, per_seq)

    def write_tokens(self, k, v, pos):
        """Write S rows per sequence at positions ``pos .. pos+S-1`` (pos
        [B]), each in its row mod W (bit for bit S ``write_token`` calls
        while S <= W)."""
        b, s = k.shape[:2]
        rows = torch.arange(b, device=k.device)[:, None]
        cols = torch.remainder(pos.long().expand(b)[:, None]
                               + torch.arange(s, device=k.device)[None, :], self.width)
        self._write(lambda c, n: c.index_put_((rows, cols), n), k, v)
        return self

    def verify_view(self, pos_b, start_b, s: int):
        raise ValueError(
            "RingCache does not support speculative verify bursts: a K-token write "
            "evicts window rows that earlier burst queries need, and rollback cannot "
            "restore them (slot = pos % W).  Serve sliding-window models with plain "
            "decode.")

    def token_view(self, pos_b, start_b):
        """The rows as stored, with the [B, W] mask of the reference's
        ``RingCache.token_view`` (:func:`ring_valid`): row j holds position
        ``pos_b - ((pos_b - j) mod W)`` and attends iff that position is
        written, at most ``pos_b``, at least ``start_b`` and inside the
        window."""
        return (self.k, self.v, self.k_s, self.v_s,
                ring_valid(pos_b, start_b, self.width, self.window))

    def write_prompt(self, k, v, pos0: int):
        s, w = k.shape[1], self.width
        if s > w:
            raise ValueError(f"prefill chunk length {s} exceeds ring width {w}; use "
                             "chunked prefill (Model.prefill splits prompts beyond the "
                             "ring width)")
        return (self, *self._write(lambda c, n: prompt_update(c, n, pos0, ring=True), k, v))

    def context(self, pos0: int):
        """The retained rows, positions ``[pos0 - ctx, pos0)`` with ctx =
        min(pos0, W), gathered into position order as a COPY: read it
        before the chunk's write, which may evict those rows."""
        ctx = min(pos0, self.width)
        if ctx == 0:
            return None, None, None, None, 0
        idx = torch.remainder(torch.arange(pos0 - ctx, pos0, device=self.k.device),
                              self.width)
        sl = lambda c: None if c is None else c[:, idx]   # noqa: E731
        return sl(self.k), sl(self.v), sl(self.k_s), sl(self.v_s), ctx


class PagedCache(_KV):
    """Fixed-size pages + per-slot block tables over a shared pool."""

    def __init__(self, k, v, block_table, page_size: int = DEFAULT_PAGE_SIZE,
                 k_s=None, v_s=None):
        self.k, self.v, self.k_s, self.v_s = k, v, k_s, v_s
        self.block_table = block_table
        self.page_size = page_size

    @property
    def width(self) -> int:
        return self.block_table.shape[-1] * self.page_size

    def write_token(self, k, v, pos, per_seq: bool):
        del per_seq   # the page scatter is per-sequence by construction
        b = k.shape[0]
        pos_b = torch.as_tensor(pos, dtype=torch.int64,
                                device=k.device).expand(b)
        # idle engine slots keep ticking past their (all-null) table row:
        # clamp their page index, whose entry is the null page anyway
        pp = torch.clamp_max(pos_b // self.page_size, self.block_table.shape[1] - 1)
        pid = self.block_table.gather(1, pp[:, None])[:, 0].long()
        off = pos_b % self.page_size
        self._write(lambda c, n: c.index_put_((pid, off), n[:, 0]), k, v)
        return self

    def write_tokens(self, k, v, pos):
        """Write S rows per sequence at ``pos .. pos+S-1`` (pos [B]) into
        the pages that hold them."""
        b, s = k.shape[:2]
        cols = pos.long().expand(b)[:, None] + torch.arange(s, device=k.device)[None, :]
        # idle engine slots (an all-null table row) clamp as write_token does
        pp = torch.clamp_max(cols // self.page_size, self.block_table.shape[1] - 1)
        pid = self.block_table.gather(1, pp).long()
        off = cols % self.page_size
        self._write(lambda c, n: c.index_put_((pid, off), n), k, v)
        return self

    def token_view(self, pos_b, start_b):
        """In-place decode read: pools + table, no gathered copy (masking
        happens in the kernel from the same [B] vectors)."""
        del pos_b, start_b
        return PagedView(self.k, self.v, self.k_s, self.v_s, self.block_table,
                         self.page_size)

    def _gather(self, c):
        """[P, page, ...] pool -> [B, W, ...] position-ordered copy."""
        if c is None:
            return None
        g = c[self.block_table.long()]
        return g.reshape((g.shape[0], -1) + tuple(c.shape[2:]))

    def verify_view(self, pos_b, start_b, s: int):
        """The burst read: the pages gathered into position order, with the
        burst's [B, S, W] mask (the in-place paged kernel stays the
        one-query decode read)."""
        return (self._gather(self.k), self._gather(self.v), self._gather(self.k_s),
                self._gather(self.v_s), burst_valid(pos_b, start_b, s, self.width))

    def gather_view(self, pos_b, start_b):
        """The decode read as the row backends give it: the pages gathered
        into position order with a [B, W] mask (unmapped tail pages sit past
        pos, masked like a dense cache's unwritten rows)."""
        idx = torch.arange(self.width, device=pos_b.device)[None, :]
        valid = (idx <= pos_b[:, None]) & (idx >= start_b[:, None])
        return (self._gather(self.k), self._gather(self.v), self._gather(self.k_s),
                self._gather(self.v_s), valid)

    def fork(self):
        """Block-table snapshot: rollback restores page mappings (a burst
        may have mapped pages the accepted prefix never reached), not page
        contents."""
        return self.block_table.clone()

    def rollback(self, snap):
        self.block_table = snap
        return self

    def write_prompt(self, k, v, pos0: int):
        s = k.shape[1]
        if pos0 + s > self.width:
            raise ValueError(f"prefill chunk [{pos0}, {pos0 + s}) exceeds "
                             f"paged cache width {self.width}")
        cols = torch.arange(pos0, pos0 + s, device=k.device)
        pid = self.block_table[:, cols // self.page_size].long()   # [B, S]
        off = (cols % self.page_size).expand_as(pid)
        return (self, *self._write(lambda c, n: c.index_put_((pid, off), n), k, v))

    def context(self, pos0: int):
        if pos0 == 0:
            return None, None, None, None, 0
        bt = self.block_table[:, :-(-pos0 // self.page_size)].long()

        def gather(c):
            if c is None:
                return None
            return c[bt].reshape((bt.shape[0], -1) + tuple(c.shape[2:]))[:, :pos0]

        return (gather(self.k), gather(self.v), gather(self.k_s),
                gather(self.v_s), pos0)

    def detached(self):
        """A copy of the pages this view's table maps, in a pool of their
        own (entry ``i`` of the flattened table becomes page ``1 + i``,
        null entries stay null), that writes leave this cache untouched:
        a read-only forward on the plain path writes its chunk there and
        attends exactly what a writing one would."""
        bt = self.block_table.long()
        ids = 1 + torch.arange(bt.numel(), device=bt.device).reshape(bt.shape)
        table = torch.where(bt != 0, ids, 0).to(self.block_table.dtype)

        def take(c):
            return None if c is None else torch.cat([c[:1], c[bt.reshape(-1)]])
        return PagedCache(take(self.k), take(self.v), table, self.page_size,
                          take(self.k_s), take(self.v_s))

    def copy_pages(self, src, dst):
        """Copy whole pages ``src[i] -> dst[i]`` in place in every pool (K,
        V and the int8 scale pools), one indexed copy a pool: the device
        half of copy-on-write.  The engine copies a still-shared page to a
        fresh one and remaps the writing slot's table BEFORE the write
        lands, so the other holders' bytes never change.  ``src``/``dst``:
        [n] int64 page ids on the pools' device."""
        for c in (self.k, self.v, self.k_s, self.v_s):
            if c is not None:
                c[dst] = c[src]
        return self

    # .. engine slot management: indices move, rows don't ..
    def prefill_view(self, slot: int):
        """A single-slot view sharing the pools: admission prefill writes
        straight through into the slot's pages."""
        return PagedCache(self.k, self.v, self.block_table[slot:slot + 1],
                          self.page_size, self.k_s, self.v_s)

    def admit(self, one, slot: int):
        """The view wrote through the shared pool: nothing to merge."""
        del one, slot
        return self

    def free_slot(self, slot: int):
        self.block_table[slot] = 0
        return self

    def with_table(self, table):
        """Adopt the engine's block-table mirror wholesale."""
        self.block_table = table
        return self


class SSMCache:
    """A Mamba-2 layer's per-slot state (port of the reference's
    ``SSMCache``): the conv window ``conv`` [B, W-1, C] in the compute
    dtype and the SSD state ``ssd`` [B, H, P, N] float32.  It joins the
    slot protocol of the row backends, so the engine moves SSM and
    attention state through one code path: ``prefill_view`` (zeroed
    single-slot state), ``admit`` (written in place at the slot),
    ``free_slot`` (a no-op: the next admission overwrites the slot),
    ``clone`` / ``copy_from`` (the engine's snapshot and restore, copied
    back into this cache's tensors in place), ``fork`` / ``rollback``
    (nothing: an SSM burst rolls back by ``select``ing a per-step state)
    and ``nbytes``.  A serving step hands its new state in with
    ``update``, which rebinds the two tensors of this object (every
    holder of the cache sees it); a speculative drafter keeps the
    tensors of each step as that step's snapshot.  No pool, table or
    window: ``with_table`` and ``copy_pages`` are no-ops."""

    window = None

    def __init__(self, conv, ssd):
        self.conv, self.ssd = conv, ssd

    def update(self, conv, ssd):
        self.conv, self.ssd = conv, ssd
        return self

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.conv, self.ssd))

    def prefill_view(self, slot: int):
        del slot
        return SSMCache(self.conv.new_zeros((1,) + tuple(self.conv.shape[1:])),
                        self.ssd.new_zeros((1,) + tuple(self.ssd.shape[1:])))

    def admit(self, one, slot: int):
        self.conv[slot] = one.conv[0]
        self.ssd[slot] = one.ssd[0]
        return self

    def free_slot(self, slot: int):
        del slot
        return self

    def clone(self):
        return SSMCache(self.conv.clone(), self.ssd.clone())

    def copy_from(self, other) -> None:
        self.conv.copy_(other.conv)
        self.ssd.copy_(other.ssd)

    def fork(self):
        return None

    def rollback(self, snap):
        del snap
        return self

    def with_table(self, table):
        del table
        return self

    def copy_pages(self, src, dst):
        del src, dst
        return self


def _pools(shape, dtype, quantized: bool, device):
    """(k, v, k_s, v_s) zero pools: int8 codes plus bf16 [..., 1] scale
    pools when ``quantized``, else ``dtype`` pools and no scales."""
    if not quantized:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), None, None)
    sshape = tuple(shape[:-1]) + (1,)
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device))


def paged_init(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype, *, quantized: bool = False,
               page_size: int = DEFAULT_PAGE_SIZE, pages: int | None = None,
               mapped: bool = True, device=None) -> PagedCache:
    """Build a PagedCache on ``device``.  ``pages`` sizes the pool
    (default: batch * pages_per_slot); ``mapped=False`` starts every
    block table unmapped (engine-managed), else slot ``b`` owns pages
    ``1 + b*pps .. (b+1)*pps`` (a drop-in for DenseCache).  ``quantized``
    makes int8 pools with bf16 ``[P, page, H, 1]`` scale pools."""
    pps = max(1, math.ceil(max_len / page_size))
    npages = batch * pps if pages is None else pages
    if mapped and npages < batch * pps:
        raise ValueError(f"identity mapping needs {batch * pps} pages, "
                         f"pool has {npages}")
    shape = (npages + 1, page_size, kv_heads, head_dim)   # +1: null page 0
    if mapped:
        table = 1 + np.arange(batch * pps, dtype=np.int32).reshape(batch, pps)
    else:
        table = np.zeros((batch, pps), np.int32)
    k, v, k_s, v_s = _pools(shape, dtype, quantized, device)
    return PagedCache(k, v, torch.from_numpy(table).to(device), page_size,
                      k_s, v_s)


def dense_init(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype, *, quantized: bool = False, device=None) -> DenseCache:
    return DenseCache(*_pools((batch, max_len, kv_heads, head_dim), dtype,
                              quantized, device))


def ring_init(batch: int, width: int, kv_heads: int, head_dim: int, dtype, *,
              window: int, quantized: bool = False, device=None) -> RingCache:
    """A RingCache of ``width`` rows per sequence (W = min(max_len, window))
    that masks reads to ``window`` positions."""
    return RingCache(*_pools((batch, width, kv_heads, head_dim), dtype, quantized, device),
                     window=window)
