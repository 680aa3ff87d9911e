"""token_stream: training batches, a frozen copy of
``repro_torch/data/pipeline.py``'s ``SyntheticSource`` (``"source":
"synthetic_zipf"``: power-law unigrams with repeats), seeded by
``--seed``; a fresh batch each step."""

from __future__ import annotations

import numpy as np

from port_bench.traffic.generator import derive


def batch(spec: dict, seed: int, vocab: int, step: int) -> np.ndarray:
    """Step ``step``'s [global_batch, seq_len + 1] int32 tokens
    (``SyntheticSource.batch(step, 0, rows, seq_len)`` with the run's seed)."""
    if spec["source"] != "synthetic_zipf":
        raise ValueError(f"token_stream draws synthetic_zipf tokens, not {spec['source']!r}")
    rows, seq = int(spec["global_batch"]), int(spec["seq_len"])
    g = np.random.default_rng(np.random.SeedSequence([derive(seed, 3), step, 0]))
    ranks = g.zipf(float(spec["zipf_a"]), size=(rows, seq + 1)).astype(np.int64)
    toks = (ranks - 1) % vocab
    rep = g.random((rows, seq + 1)) < float(spec["repeat_p"])
    toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
    return toks.astype(np.int32)
