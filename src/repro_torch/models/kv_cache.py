"""KV-cache backends (port of ``repro/models/kv_cache.py``): the paged
pool the serving engine admits into, and the dense rows the paged ≡
dense test holds it against.

The reference's caches are immutable pytrees: every write returns a new
cache.  Here the writes land IN PLACE (``index_put_`` / slice
assignment into the pool tensors) and the methods return ``self``, so
callers keep the reference's ``new = cache.write_...`` shape without a
pool-sized copy per token.  Nothing in this slice keeps an old cache
alive across a write (fork/rollback and engine snapshots are later
work), so in-place updates are safe.

:class:`PagedCache` keeps per-layer ``[P, page, H, hd]`` pools, page 0
being the reserved null page, plus a ``[B, pages_per_slot]`` int32 block
table; ``token_view`` returns the pool and table as stored
(:class:`PagedView`) for the paged decode kernel.  int8-KV pools wait
for a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_PAGE_SIZE = 16


class PagedView(NamedTuple):
    """In-place decode read: pools as stored plus the block table."""

    k: torch.Tensor                  # [P, page, H, hd] pool
    v: torch.Tensor
    k_s: torch.Tensor | None         # int8-KV scale pools (not ported: None)
    v_s: torch.Tensor | None
    block_table: torch.Tensor        # [B, pages_per_slot] int32
    page_size: int


class DenseCache:
    """Contiguous [B, W, H, hd] rows; slot = absolute position."""

    def __init__(self, k, v):
        self.k, self.v = k, v

    @property
    def width(self) -> int:
        return self.k.shape[1]

    def write_token(self, k, v, pos, per_seq: bool):
        """Write one row per sequence at ``pos`` (scalar or [B])."""
        if per_seq:
            rows = torch.arange(k.shape[0], device=k.device)
            self.k[rows, pos.long()] = k[:, 0].to(self.k.dtype)
            self.v[rows, pos.long()] = v[:, 0].to(self.v.dtype)
        else:
            self.k[:, int(pos)] = k[:, 0].to(self.k.dtype)
            self.v[:, int(pos)] = v[:, 0].to(self.v.dtype)
        return self

    def token_view(self, pos_b, start_b):
        idx = torch.arange(self.width, device=pos_b.device)[None, :]
        valid = (idx <= pos_b[:, None]) & (idx >= start_b[:, None])
        return self.k, self.v, None, None, valid

    def write_prompt(self, k, v, pos0: int):
        s = k.shape[1]
        if pos0 + s > self.width:
            raise ValueError(f"prefill chunk [{pos0}, {pos0 + s}) exceeds "
                             f"cache width {self.width}")
        kc, vc = k.to(self.k.dtype), v.to(self.v.dtype)
        self.k[:, pos0:pos0 + s] = kc
        self.v[:, pos0:pos0 + s] = vc
        return self, kc, vc, None, None

    def context(self, pos0: int):
        if pos0 == 0:
            return None, None, None, None, 0
        return self.k[:, :pos0], self.v[:, :pos0], None, None, pos0


class PagedCache:
    """Fixed-size pages + per-slot block tables over a shared pool."""

    def __init__(self, k, v, block_table, page_size: int = DEFAULT_PAGE_SIZE):
        self.k, self.v = k, v
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
        self.k.index_put_((pid, off), k[:, 0].to(self.k.dtype))
        self.v.index_put_((pid, off), v[:, 0].to(self.v.dtype))
        return self

    def token_view(self, pos_b, start_b):
        """In-place decode read: pool + table, no gathered copy (masking
        happens in the kernel from the same [B] vectors)."""
        del pos_b, start_b
        return PagedView(self.k, self.v, None, None, self.block_table,
                         self.page_size)

    def write_prompt(self, k, v, pos0: int):
        s = k.shape[1]
        if pos0 + s > self.width:
            raise ValueError(f"prefill chunk [{pos0}, {pos0 + s}) exceeds "
                             f"paged cache width {self.width}")
        cols = torch.arange(pos0, pos0 + s, device=k.device)
        pid = self.block_table[:, cols // self.page_size].long()   # [B, S]
        off = (cols % self.page_size).expand_as(pid)
        kc, vc = k.to(self.k.dtype), v.to(self.v.dtype)
        self.k.index_put_((pid, off), kc)
        self.v.index_put_((pid, off), vc)
        return self, kc, vc, None, None

    def context(self, pos0: int):
        if pos0 == 0:
            return None, None, None, None, 0
        bt = self.block_table[:, :-(-pos0 // self.page_size)].long()

        def gather(c):
            return c[bt].reshape((bt.shape[0], -1) + tuple(c.shape[2:]))[:, :pos0]

        return gather(self.k), gather(self.v), None, None, pos0

    # .. engine slot management: indices move, rows don't ..
    def prefill_view(self, slot: int):
        """A single-slot view sharing the pools: admission prefill writes
        straight through into the slot's pages."""
        return PagedCache(self.k, self.v,
                          self.block_table[slot:slot + 1], self.page_size)

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


def paged_init(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype, *, page_size: int = DEFAULT_PAGE_SIZE,
               pages: int | None = None, mapped: bool = True,
               device=None) -> PagedCache:
    """Build a PagedCache on ``device``.  ``pages`` sizes the pool
    (default: batch * pages_per_slot); ``mapped=False`` starts every
    block table unmapped (engine-managed), else slot ``b`` owns pages
    ``1 + b*pps .. (b+1)*pps`` (a drop-in for DenseCache)."""
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
    return PagedCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device),
                      torch.from_numpy(table).to(device), page_size)


def dense_init(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype, *, device=None) -> DenseCache:
    shape = (batch, max_len, kv_heads, head_dim)
    return DenseCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))
