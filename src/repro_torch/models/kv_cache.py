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
(:class:`PagedView`) for the paged decode kernel.

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

DEFAULT_PAGE_SIZE = 16


class PagedView(NamedTuple):
    """In-place decode read: pools as stored plus the block table."""

    k: torch.Tensor                  # [P, page, H, hd] pool
    v: torch.Tensor
    k_s: torch.Tensor | None         # [P, page, H, 1] bf16 int8-KV scales
    v_s: torch.Tensor | None
    block_table: torch.Tensor        # [B, pages_per_slot] int32
    page_size: int


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
    form (the operands prefill attends to)."""

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

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

    def token_view(self, pos_b, start_b):
        idx = torch.arange(self.width, device=pos_b.device)[None, :]
        valid = (idx <= pos_b[:, None]) & (idx >= start_b[:, None])
        return self.k, self.v, self.k_s, self.v_s, valid

    def write_prompt(self, k, v, pos0: int):
        s = k.shape[1]
        if pos0 + s > self.width:
            raise ValueError(f"prefill chunk [{pos0}, {pos0 + s}) exceeds "
                             f"cache width {self.width}")

        def put(c, n):
            c[:, pos0:pos0 + s] = n
        return (self, *self._write(put, k, v))

    def context(self, pos0: int):
        if pos0 == 0:
            return None, None, None, None, 0
        sl = lambda c: None if c is None else c[:, :pos0]   # noqa: E731
        return sl(self.k), sl(self.v), sl(self.k_s), sl(self.v_s), pos0


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

    def token_view(self, pos_b, start_b):
        """In-place decode read: pools + table, no gathered copy (masking
        happens in the kernel from the same [B] vectors)."""
        del pos_b, start_b
        return PagedView(self.k, self.v, self.k_s, self.v_s, self.block_table,
                         self.page_size)

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

    @property
    def nbytes(self) -> int:
        """Bytes of the K/V pools and their scale pools."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_s, self.v_s) if t is not None)

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
