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

Speculative verify (``spec_verify``, reference :115): ``greedy_verify``
is argmax matching.  "match" mode couples acceptance to this sampler:
position t of a burst draws exactly the uniforms ``sample_logits`` would
draw on the (t+1)-th tick from now and samples from them with the same
arithmetic (:func:`_gumbel_tokens`), so a draft is accepted iff plain
decode would have sampled it; each generator is left in its state after
``n_acc + 1`` draws (a snapshot after every draw).  "rejection" mode
keeps the reference's arithmetic (accept draft d when u < p_target(d),
else sample the residual with d excluded; the bonus sample after a clean
sweep) on the port's generators: position t draws one uniform for the
acceptance, then V for its sample.  Greedy rows touch no generator.

Temperatures given as host values (a sequence or numpy array, as the
engine passes them) choose the sampled rows on the host, and the few
small tensors that need them reach the card by a pinned, non-blocking
upload: a tick that samples syncs the stream only where its caller
pulls the tokens.  A device tensor of temperatures is read back once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import upload

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


def _hot_rows(temperature, b: int, device):
    """Per-row temperatures on the host (read back once if given as a
    device tensor) -> (the rows sampled at temperature > 0, and, when
    there are any, ([n_hot] row indices, [n_hot] f32 temperatures) on
    ``device``)."""
    if torch.is_tensor(temperature):
        temperature = temperature.tolist()
    host = np.broadcast_to(np.asarray(temperature, np.float32), (b,))
    hot = [i for i in range(b) if host[i] > 0]
    if not hot:
        return hot, None, None
    return hot, upload(hot, device, np.int64), upload(host[hot], device)


def _gumbel_tokens(lt, u):
    """Rows of (truncated, tempered) logits ``lt`` [n, V] and uniforms
    ``u`` [n, V] -> Gumbel-max tokens [n] int32."""
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return (lt + gumbel).argmax(-1).to(torch.int32)


def sample_logits(logits, keys, temperature, *, top_k: int | None = None,
                  top_p: float | None = None, done=None, pad_id: int = 0):
    """One token per row.  logits [B, V]; keys: B generators (advanced
    in place, only for rows sampled at temperature > 0); temperature
    [B] (tensor or sequence).  Returns (tokens [B] int32, keys)."""
    l32 = logits.to(torch.float32)
    b, v = l32.shape
    greedy = l32.argmax(-1).to(torch.int32)
    hot, rows, temp = _hot_rows(temperature, b, l32.device)
    tok = greedy
    if hot:
        lt = _truncate(l32[rows] / temp[:, None], top_k, top_p)
        u = torch.stack([
            torch.rand(v, generator=keys[i], device=l32.device,
                       dtype=torch.float32) for i in hot])
        tok = greedy.clone()
        tok[rows] = _gumbel_tokens(lt, u)
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


# .. speculative verify ..

def _accepted(ok):
    """[B, S-1] per-draft acceptance -> accepted prefix lengths [B] int32."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def greedy_verify(logits, draft):
    """All-greedy verify.  logits [B, S, V], draft [B, S-1] -> (tokens
    [B, S] int32 per-position argmax, n_acc [B] int32: drafts matching it
    in a row).  No generator is touched."""
    tokens = logits.to(torch.float32).argmax(-1).to(torch.int32)
    return tokens, _accepted(draft == tokens[:, :-1])


def rejection_parts(logits, draft, temperature, top_k: int | None = None,
                    top_p: float | None = None):
    """The deterministic half of rejection mode: (truncated tempered
    logits lt [B, S, V] (temperature 1 for greedy rows), the target's
    probability of each draft p_target(d) [B, S-1], the residual logits
    [B, S-1, V]: lt with the draft excluded)."""
    l32 = logits.to(torch.float32)
    b, s, v = l32.shape
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=l32.device).expand(b)
    tsafe = torch.where(temp > 0, temp, 1.0)[:, None, None]
    lt = _truncate((l32 / tsafe).reshape(b * s, v), top_k, top_p).reshape(b, s, v)
    e = torch.exp(lt - lt.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    d = draft.long()[..., None]
    p_draft = probs[:, :-1].gather(-1, d)[..., 0]
    res_lt = lt[:, :-1].scatter(-1, d, _NEG_INF)
    return lt, p_draft, res_lt


def _draws(keys, hot, s, sizes, device):
    """For each hot row i, ``s`` positions of uniforms from ``keys[i]``: at
    each position one tensor per entry of ``sizes``, drawn in that order.
    Returns ([per size: [n_hot, s, size]], per hot row the generator
    states after each position)."""
    out = [[] for _ in sizes]
    states = []
    for i in hot:
        per = [[] for _ in sizes]
        after = []
        for _ in range(s):
            for j, n in enumerate(sizes):
                per[j].append(torch.rand(n, generator=keys[i], device=device,
                                         dtype=torch.float32))
            after.append(keys[i].get_state())
        for j in range(len(sizes)):
            out[j].append(torch.stack(per[j]))
        states.append(after)
    return [torch.stack(o) for o in out], states


def spec_verify(logits, draft, keys, temperature, *, top_k: int | None = None,
                top_p: float | None = None, mode: str = "match"):
    """Speculative accept / sample over one verify burst.  logits [B, S,
    V] (column 0: the last committed token's position), draft [B, S-1],
    keys: B generators, temperature [B].  Returns (tokens [B, S] int32,
    n_acc [B] int32, keys): the engine emits ``tokens[b, :n_acc[b] + 1]``.
    Hot rows' generators end in their state after ``n_acc + 1``
    positions' draws; greedy rows' are not touched."""
    if mode not in ("match", "rejection"):
        raise ValueError(f"unknown spec_verify mode {mode!r}")
    l32 = logits.to(torch.float32)
    b, s, v = l32.shape
    dev = l32.device
    hot, rows, temp = _hot_rows(temperature, b, dev)
    greedy_tok = l32.argmax(-1).to(torch.int32)
    ok = draft == greedy_tok[:, :-1]
    tokens = greedy_tok
    if hot:
        n = len(hot)
        if mode == "match":
            (u,), states = _draws(keys, hot, s, (v,), dev)
            lt = _truncate((l32[rows] / temp[:, None, None]).reshape(n * s, v),
                           top_k, top_p)
            tok = _gumbel_tokens(lt, u.reshape(n * s, v)).reshape(n, s)
            ok_hot = draft[rows] == tok[:, :-1]
        else:
            (a, u), states = _draws(keys, hot, s, (1, v), dev)
            lt, p_draft, res_lt = rejection_parts(l32[rows], draft[rows], temp,
                                                  top_k, top_p)
            ok_hot = a[:, :-1, 0] < p_draft
            res_tok = _gumbel_tokens(res_lt.reshape(-1, v),
                                     u[:, :-1].reshape(-1, v)).reshape(n, s - 1)
            bonus = _gumbel_tokens(lt[:, -1], u[:, -1])
            alt = torch.cat([res_tok, bonus[:, None]], dim=1)
            d = draft[rows].to(torch.int32)
            path = torch.cat([d, d[:, -1:]], dim=1)
            n_hot = _accepted(ok_hot)
            tok = torch.where(torch.arange(s, device=dev)[None, :] < n_hot[:, None], path, alt)
        tokens = greedy_tok.clone()
        tokens[rows] = tok
        ok[rows] = ok_hot
    n_acc = _accepted(ok)
    if hot:
        acc = n_acc.cpu().tolist()
        for j, i in enumerate(hot):
            keys[i].set_state(states[j][acc[i]])
    return tokens, n_acc, keys


@functools.lru_cache(maxsize=None)
def make_spec_verifier(top_k: int | None = None, top_p: float | None = None,
                       mode: str = "match"):
    """(logits [B, S, V], draft [B, S-1], keys, temperature [B]) ->
    (tokens, n_acc, keys) with the truncation knobs and mode bound."""
    def verifier(logits, draft, keys, temperature):
        return spec_verify(logits, draft, keys, temperature, top_k=top_k,
                           top_p=top_p, mode=mode)
    return verifier
