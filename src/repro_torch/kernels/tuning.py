"""Shape-keyed launch plans of the port's Hopper kernels (port of
``repro/kernels/tuning.py``, the reference's block-size table).

Every kernel wrapper with a runtime knob asks :func:`get_block_config`
for its launch's plan instead of computing it in place.  The families
and their knobs are the Hopper kernels' own:

* ``ent_matmul_packed_fused`` (kernel 1), ``ent_matmul_packed`` (4),
  ``ent_matmul`` (5) and ``int8_matmul`` (6), shape (m, k, n): ``route``
  ("stream", the split-K weight stream, or "tc", the int8 tensor-core
  loop); on the stream ``mb`` rows a block and ``kslice`` rows a K slice,
  on the tensor-core loop ``kslice``;
* ``paged_attention`` (kernels 3 and 3b), shape (b, hkv, pps): ``pages``
  a split;
* ``ring_decode`` (the ring form, row 2r), shape (b, hkv, w): ``rows`` a
  split.

The flash kernels (2, 7, 7b, 7c) and the SSD kernels (8, 8b, 8c, 8p) fix
their tiles as template constants per head dim and have no runtime knob:
they are not in the table.

Resolution order for a (family, shape) query on a card of ``sms`` SMs:

1. the in-memory table (autotuned or recorded this process, or loaded
   from the JSON cache at the first query);
2. the persistent JSON cache (``REPRO_TORCH_TUNING_CACHE``, default
   ``~/.cache/repro_torch/tuning.json``) that :func:`autotune` writes;
3. the heuristic defaults, which are the wrappers' own plans
   (``route_of`` by each kernel's cut, ``stream_plan``, ``tc_plan``,
   ``split_plan``, ``ring_split_plan``): an empty table changes no launch.

Keys bucket each dim to a power of two, ``family:AxBxC@SMS``: one entry
covers a bucket on one kind of card.  A cached entry that the launcher of
this launch's dims would refuse (``_valid``, the launchers' own rules) is
ignored, and overrides always win.  Resolutions are memoised per exact
(family, shape, SMs, cut, route): a serving tick makes ~2,000 launches on
a host-bound path.  :func:`record`, :func:`clear` and :func:`reload` drop
the memo.  A memoised plan is shared and read-only.
"""

from __future__ import annotations

import json
import os
import statistics
from types import MappingProxyType

__all__ = [
    "get_block_config",
    "autotune",
    "matmul_candidates",
    "paged_attention_candidates",
    "ring_decode_candidates",
    "record",
    "clear",
    "reload",
    "cache_path",
]

MATMUL_FAMILIES = ("ent_matmul_packed_fused", "ent_matmul_packed", "ent_matmul", "int8_matmul")
PAGED_FAMILIES = ("paged_attention",)
RING_FAMILIES = ("ring_decode",)
ROUTES = ("stream", "tc")
# the knobs of each matmul route and of the attention families
KNOBS = {"stream": {"route", "mb", "kslice"}, "tc": {"route", "kslice"},
         "paged_attention": {"pages"}, "ring_decode": {"rows"}}

# key -> config dict.  Populated by autotune() / record() and by the JSON
# cache; consulted before the heuristics.
_TABLE: dict = {}
_LOADED = False
# (family, shape, sms, cut, route) -> read-only resolved config
_MEMO: dict = {}


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "tuning.json"),
    )


def _bucket(dim: int) -> int:
    """Round up to a power of two — one table entry per bucket."""
    b = 1
    while b < dim:
        b *= 2
    return b


def _key(family: str, shape, sms: int) -> str:
    return f"{family}:" + "x".join(str(_bucket(int(d))) for d in shape) + f"@{int(sms)}"


def _load() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    try:
        with open(cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return  # missing, truncated or corrupt cache: start from heuristics
    if isinstance(data, dict):  # tolerate a clobbered non-dict payload too
        _TABLE.update({k: v for k, v in data.items() if isinstance(v, dict)})


def _save() -> None:
    path = cache_path()
    # write-to-temp + atomic rename: concurrent processes each land a
    # complete file instead of interleaving into corrupt JSON
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(_TABLE, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        # read-only FS: the in-memory table still serves this process
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _fit(dim: int, cap: int) -> int:
    """Largest power-of-two block <= cap that divides dim (>=1)."""
    b = 1
    while b < cap:
        b *= 2
    while b > 1 and (b > cap or dim % b != 0):
        b //= 2
    return b


def _matmul_module(family: str):
    """The module of ``family``'s wrapper, which holds its cut."""
    if family == "int8_matmul":
        from repro_torch.kernels.int8_matmul import int8_matmul
        return int8_matmul
    from repro_torch.kernels.ent_matmul import ent_matmul
    return ent_matmul


def _cut(family: str) -> int:
    """``family``'s route cut, read at call time (chip_smoke.py moves one)."""
    attr = {"ent_matmul_packed": "M_STREAM_PACKED",
            "ent_matmul": "M_STREAM_PLANES"}.get(family, "M_STREAM")
    return getattr(_matmul_module(family), attr)


def _heuristic(family: str, shape, sms: int, cut=None, route=None) -> dict:
    """The wrapper's own plan: what every launch took before the table."""
    if family in MATMUL_FAMILIES:
        from repro_torch.kernels.ent_matmul import ent_matmul as em
        m, k, n = (int(d) for d in shape)
        if route is None:
            route = em.route_of(m, _cut(family) if cut is None else cut)
        if route == "stream":
            mb, kslice, _, _ = em.stream_plan(m, n, k, sms)
            return {"route": "stream", "mb": mb, "kslice": kslice}
        return {"route": "tc", "kslice": em.tc_plan(m, n, k, sms, em.tc_bm(family))[0]}
    if family in PAGED_FAMILIES:
        from repro_torch.kernels.paged_attention import paged_attention as pa
        return {"pages": pa.split_plan(*(int(d) for d in shape), sms)[0]}
    if family in RING_FAMILIES:
        from repro_torch.kernels.paged_attention import paged_attention as pa
        return {"rows": pa.ring_split_plan(*(int(d) for d in shape), sms)[0]}
    raise KeyError(f"unknown kernel family: {family}")


def _valid(family: str, shape, cfg: dict) -> bool:
    """Would this launch's launcher take the plan?  (The launchers' own
    rules, ``csrc/int8_stream.cuh``, ``csrc/int8_tc.cuh`` and
    ``csrc/paged_attention.cu``, with the wrappers' caps; a table entry
    may come from elsewhere in the bucket, or be clobbered.)"""
    knobs = KNOBS.get(cfg.get("route"), KNOBS.get(family))
    if knobs is None or not set(cfg) <= knobs:   # another family's or route's knob
        return False
    try:
        if family in MATMUL_FAMILIES:
            from repro_torch.kernels.ent_matmul import ent_matmul as em
            k, kslice = int(shape[1]), cfg["kslice"]
            if type(kslice) is not int or kslice <= 0:
                return False
            if cfg["route"] == "stream":
                return (type(cfg["mb"]) is int and cfg["mb"] in em.STREAM_MB
                        and kslice % em.STREAM_KSTEP == 0
                        and kslice <= em.STREAM_KSLICE_MAX)
            return cfg["route"] == "tc" and kslice % em.TC_BK == 0 and -(-k // kslice) <= 65535
        from repro_torch.kernels.paged_attention import paged_attention as pa
        if family in PAGED_FAMILIES:
            pages = cfg["pages"]
            return type(pages) is int and 1 <= pages <= pa.MAX_RUN_PAGES
        rows = cfg["rows"]
        return (type(rows) is int and pa.STAGE_ROWS <= rows <= pa.MAX_RING_ROWS
                and rows % pa.STAGE_ROWS == 0)
    except (KeyError, TypeError):
        return False


def _resolve(family: str, shape, sms: int, cut, route) -> dict:
    _load()
    cached = _TABLE.get(_key(family, shape, sms))
    if cached is not None and route in (None, cached.get("route", route)):
        cfg = {**_heuristic(family, shape, sms, cut, route or cached.get("route")), **cached}
        if _valid(family, shape, cfg):
            return cfg
    return _heuristic(family, shape, sms, cut, route)


def get_block_config(family: str, shape, overrides: dict | None = None, *, sms: int,
                     cut: int | None = None, route: str | None = None):
    """The plan of one launch of ``family`` at ``shape`` on a card of
    ``sms`` SMs: table, cache, then the heuristic; ``route`` (matmul
    families) asks for that route's plan, ``cut`` replaces the family's
    route cut; explicit ``overrides`` always win (None values ignored)."""
    if cut is None and route is None and family in MATMUL_FAMILIES:
        cut = _cut(family)
    key = (family, tuple(shape), sms, cut, route)
    cfg = _MEMO.get(key)
    if cfg is None:
        cfg = _MEMO[key] = MappingProxyType(_resolve(family, shape, sms, cut, route))
    if overrides:
        cfg = {**cfg, **{k: v for k, v in overrides.items() if v is not None}}
    return cfg


def empty() -> bool:
    """Whether the table (with the cache file, once read) holds nothing:
    every plan is then the heuristic's."""
    _load()
    return not _TABLE


def record(family: str, shape, config: dict, *, sms: int, persist: bool = True) -> None:
    """Pin ``config`` for the shape bucket on ``sms``-SM cards (and persist it)."""
    _load()
    _TABLE[_key(family, shape, sms)] = dict(config)
    _MEMO.clear()
    if persist:
        _save()


def clear() -> None:
    """Drop the in-memory table (tests)."""
    global _LOADED
    _TABLE.clear()
    _MEMO.clear()
    _LOADED = True  # don't reload the file over a deliberate clear


def reload() -> None:
    """Drop the in-memory table and read the cache file again at the
    next query."""
    global _LOADED
    clear()
    _LOADED = False


def matmul_candidates(family: str, m: int, k: int, n: int, *, sms: int,
                      route: str | None = None) -> list[dict]:
    """A sweep for kernel 1, 4, 5 or 6 on ``route`` (None: both): the
    heuristic's plan and K slices of whole powers of two that divide K
    (equal splits), each block height of the stream; every one valid."""
    out = []
    for r in ROUTES if route is None else (route,):
        base = _heuristic(family, (m, k, n), sms, route=r)
        slices = [base["kslice"]] + [_fit(k, cap) for cap in (256, 512, 1024, 2048, 4096)]
        if r == "stream":
            from repro_torch.kernels.ent_matmul import ent_matmul as em
            out += [{"route": r, "mb": mb, "kslice": ks} for mb in em.STREAM_MB for ks in slices]
        else:
            out += [{"route": r, "kslice": ks} for ks in slices]
    uniq = {tuple(sorted(c.items())): c for c in out if _valid(family, (m, k, n), c)}
    return list(uniq.values())


def paged_attention_candidates(b: int, hkv: int, pps: int, *, sms: int) -> list[dict]:
    """A sweep of pages a split for kernels 3 / 3b: the heuristic's and
    the powers of two up to the table row and MAX_RUN_PAGES."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    pages = [_heuristic("paged_attention", (b, hkv, pps), sms)["pages"]]
    pages += [p for p in (1, 2, 4, 8, 16, 32, 64) if p <= min(max(pps, 1), pa.MAX_RUN_PAGES)]
    return [{"pages": p} for p in dict.fromkeys(pages)]


def ring_decode_candidates(b: int, hkv: int, w: int, *, sms: int) -> list[dict]:
    """A sweep of rows a split for the ring decode: the heuristic's and
    whole powers of two of 32-row stages up to the ring and MAX_RING_ROWS."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    top = min(-(-w // pa.STAGE_ROWS) * pa.STAGE_ROWS, pa.MAX_RING_ROWS)
    rows = [_heuristic("ring_decode", (b, hkv, w), sms)["rows"]]
    rows += [pa.STAGE_ROWS << i for i in range(8) if pa.STAGE_ROWS << i <= top]
    return [{"rows": r} for r in dict.fromkeys(rows)]


class CudaTimer:
    """Seconds a call of ``fn``: the median over ``iters`` calls, each
    timed with CUDA events after a 256 MB read that evicts the L2 (as
    chip_smoke.py's Timer), read after a synchronise."""

    def __init__(self):
        import torch
        self.torch = torch
        self.flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
        self.sink = torch.empty((), dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int, warmup: int) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        evs = []
        for _ in range(iters):
            torch.sum(self.flush, dim=0, out=self.sink)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs) / 1e3


def autotune(family: str, shape, bench, candidates: list[dict], *, sms: int,
             iters: int = 5, warmup: int = 2, persist: bool = True, timer=None) -> dict:
    """Time ``bench(config)`` (one launch with that plan) over
    ``candidates`` and pin the fastest for the shape bucket.  ``timer(fn,
    iters, warmup) -> seconds a call`` defaults to a :class:`CudaTimer`.
    A candidate whose launch raises (or whose timing does) is
    disqualified; with none left the heuristic is pinned."""
    _load()
    timer = CudaTimer() if timer is None else timer
    best, best_t = None, float("inf")
    for cfg in candidates:
        try:
            dt = timer(lambda: bench(cfg), iters, warmup)
        except Exception:
            continue
        if dt < best_t:
            best, best_t = cfg, dt
    if best is None:
        best = _heuristic(family, shape, sms)
    record(family, shape, best, sms=sms, persist=persist)
    return best
