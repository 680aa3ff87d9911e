"""Batched on-device sampling for the serving engine (port of
``repro/runtime/sampling.py``).

Semantics per row b, as in the reference:

* ``temperature[b] <= 0``: greedy argmax (its generator is not touched);
* otherwise: softmax sampling at that temperature via the Gumbel trick,
  after optional top-k and nucleus (top-p) truncation (``_truncate``,
  which matches the reference exactly);
* ``done[b]``: emit ``pad_id``.

Randomness comes from one ``torch.Generator`` per row (per request in
the engine, seeded from ``(seed, uid)``), so a request replays the same
stream whichever slot or neighbours it lands with.  The draws differ
from the reference's threefry keys; the distributions are the same.
"""

from __future__ import annotations

import functools

import torch

_NEG_INF = -1e30


def _truncate(lt, top_k, top_p):
    """Per-row top-k / nucleus logit truncation (row-wise)."""
    v = lt.shape[-1]
    if top_k is not None and top_k < v:
        kth = torch.topk(lt, top_k, dim=-1).values[:, -1:]
        lt = torch.where(lt < kth, _NEG_INF, lt)
    if top_p is not None and top_p < 1.0:
        order = torch.argsort(-lt, dim=-1, stable=True)
        sorted_lt = torch.gather(lt, -1, order)
        e = torch.exp(sorted_lt - sorted_lt.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
        # exclusive cumsum: a token is kept while the mass BEFORE it is
        # below top_p, so the head token always survives
        before = torch.cumsum(probs, dim=-1) - probs
        keep = torch.zeros_like(before, dtype=torch.bool).scatter(
            -1, order, before < top_p)
        lt = torch.where(keep, lt, _NEG_INF)
    return lt


_M64 = (1 << 64) - 1


def _mix(seed: int, uid: int) -> int:
    """splitmix64 of (seed, uid), cut to 32 bits: the CPU generator
    (mt19937) keeps only the low 32 bits of its seed, so the pair is
    hashed rather than concatenated."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(uid) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def seed_generator(seed: int, uid: int, device) -> torch.Generator:
    """The per-request generator: seeded from ``(seed, uid)`` only."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, uid))
    return g


def init_keys(seed: int, batch: int, device=None) -> list[torch.Generator]:
    """One generator per row, seeded from ``(seed, row)``."""
    return [seed_generator(seed, i, device or "cpu") for i in range(batch)]


def sample_logits(logits, keys, temperature, *, top_k: int | None = None,
                  top_p: float | None = None, done=None, pad_id: int = 0):
    """One token per row.  logits [B, V]; keys: B generators (advanced
    in place, only for rows sampled at temperature > 0); temperature
    [B] (tensor or sequence).  Returns (tokens [B] int32, keys)."""
    l32 = logits.to(torch.float32)
    b, v = l32.shape
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=l32.device).expand(b)
    greedy = l32.argmax(-1).to(torch.int32)
    hot = [i for i, t in enumerate(temp.tolist()) if t > 0]
    tok = greedy
    if hot:
        rows = torch.tensor(hot, device=l32.device)
        lt = _truncate(l32[rows] / temp[rows][:, None], top_k, top_p)
        u = torch.stack([
            torch.rand(v, generator=keys[i], device=l32.device,
                       dtype=torch.float32) for i in hot])
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
        tok = greedy.clone()
        tok[rows] = (lt + gumbel).argmax(-1).to(torch.int32)
    if done is not None:
        tok = torch.where(done, pad_id, tok)
    return tok, keys


@functools.lru_cache(maxsize=None)
def make_sampler(top_k: int | None = None, top_p: float | None = None,
                 pad_id: int = 0):
    """(logits [B, V], keys, temperature [B], done [B]?) -> (tokens, keys)
    with the truncation knobs bound."""
    def sampler(logits, keys, temperature, done=None):
        return sample_logits(logits, keys, temperature, top_k=top_k,
                             top_p=top_p, done=done, pad_id=pad_id)
    return sampler


def greedy(logits):
    """Greedy argmax tokens [B] int32."""
    return logits.argmax(-1).to(torch.int32)
