"""Data pipeline: deterministic token streams with prefetch (the port's
own copy of ``repro/data/pipeline.py``, numpy only).

* **Determinism as the fault-tolerance primitive**: every batch is a pure
  function of (seed, step, host_index), so a restarted host reproduces
  exactly the shard it owes, and these batches are the reference's,
  bit for bit.
* **Per-host sharding**: each host materializes only global_batch /
  num_hosts rows.
* **Sources**: synthetic LM stream (seeded zipf-ish token model) or a
  binary token file (np.memmap), both behind the same iterator API.
* **Prefetch**: a background thread keeps ``depth`` batches ready.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenStream", "SyntheticSource", "FileSource", "Prefetcher"]


class SyntheticSource:
    """Deterministic synthetic LM tokens (power-law unigram + ngram-ish
    structure so losses move during example training runs)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, host: int, rows: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        # zipf-ish marginal over the vocab
        ranks = rng.zipf(1.3, size=(rows, seq_len + 1)).astype(np.int64)
        toks = (ranks - 1) % self.vocab
        # inject local structure: repeat previous token with prob .25
        rep = rng.random((rows, seq_len + 1)) < 0.25
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        return toks.astype(np.int32)


class FileSource:
    """Flat binary int32 token file, read as a ring (np.memmap)."""

    def __init__(self, path: str, vocab_size: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab = vocab_size

    def batch(self, step: int, host: int, rows: int, seq_len: int) -> np.ndarray:
        n = len(self.tokens)
        span = seq_len + 1
        out = np.empty((rows, span), np.int32)
        for r in range(rows):
            start = ((step * 7919 + host * 104729 + r) * span) % max(n - span, 1)
            out[r] = self.tokens[start:start + span]
        return np.clip(out, 0, self.vocab - 1)


class TokenStream:
    """Per-host LM batch iterator: {'tokens': [rows, S], 'labels': ...}."""

    def __init__(self, source, *, global_batch: int, seq_len: int,
                 num_hosts: int = 1, host_index: int = 0, start_step: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} does not split over "
                             f"{num_hosts} hosts")
        self.source = source
        self.rows = global_batch // num_hosts
        self.seq_len = seq_len
        self.num_hosts = num_hosts
        self.host_index = host_index
        self.step = start_step

    def seek(self, step: int):
        """Checkpoint-resume: jump the stream to a step (pure function of
        step => exact)."""
        self.step = step

    def next(self, host_index: int | None = None) -> dict:
        """Batch for this step; ``host_index`` picks another host's shard."""
        h = self.host_index if host_index is None else host_index
        toks = self.source.batch(self.step, h, self.rows, self.seq_len)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        while True:
            yield self.next()


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches."""

    def __init__(self, stream: TokenStream, depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.stream.next()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
