"""What every kind of traffic shares: seeds derived from the run's
``--seed`` and stratified sizes.  A cell's traffic file names its kind
(``"generator"``), a module of this folder found by that name:

* ``closed_loop.py``: requests from a fixed pool of clients, for the
  serving driver;
* ``token_stream.py``: training batches, for the training driver.

A serving kind provides ``Arrivals(spec, seed, vocab)`` with ``start()``,
``after(done, elapsed)`` and ``due(elapsed)``, each returning the
``Request``s to send then; a training kind provides ``batch(spec, seed,
vocab, step)``.  So a new kind of traffic is a new module here and a data
file, and no driver changes.  The run's ``--seed`` draws the token ids and
the order, never the sizes, so every seed does the same amount of work.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np


def kind(spec: dict):
    """The module of this folder that ``spec["generator"]`` names."""
    return importlib.import_module(f"port_bench.traffic.{spec['generator']}")


def derive(seed: int, *tags: int) -> int:
    """A 62-bit seed from the run's ``seed`` (any whole number) and
    ``tags``: the same inputs give the same number."""
    words = [seed % (1 << 64), seed // (1 << 64) % (1 << 64), *tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 2)


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def quantiles(dist: dict, n: int) -> list[int]:
    """``n`` stratified sizes of ``dist`` ({"dist": "log_uniform" |
    "uniform", "lo", "hi"}, inclusive integer bounds), smallest first."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    us = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "log_uniform":
        vals = [round(math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))) for u in us]
    elif dist["dist"] == "uniform":
        vals = [lo + int(u * (hi - lo + 1)) for u in us]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [min(max(v, lo), hi) for v in vals]


@dataclass
class Request:
    client: int
    round: int
    prompt: list
    max_new: int
