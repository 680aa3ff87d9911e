"""Continuous-batching serving demo on the PyTorch port: a ragged request
stream through the ServeEngine (batched prefill on admission, per-slot
EOS stop, finished slots refilled while the rest keep decoding, streamed
tokens), then the same first request through the one-shot ``generate``.

The engine runs on the paged KV-cache backend by default: admission maps
fixed-size pages from a shared pool and prefills straight through the
slot's block table, and a finished request's pages return to the pool.
Pass ``cache_kind="dense"`` to ``ServeEngine`` for dense rows; a
sliding-window model (``--arch starcoder2-15b``) serves on the ring.

    PYTHONPATH=src python examples/torch_serve_engine.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.serve_loop import ServeEngine, generate

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen2.5-3b")
ap.add_argument("--device", default=None, choices=["cuda", "cpu"], help="default: cuda")
args = ap.parse_args()

cfg = reduced_config(get_config(args.arch))
model = Model(cfg, device=args.device)
gen = torch.Generator(device=model.device)
gen.manual_seed(0)
params = model.init(gen)

# a ragged burst of requests: more requests than slots, varied lengths
rng = np.random.default_rng(0)
prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
           for n in rng.integers(3, 24, size=6)]

stream: dict[int, int] = {}


def on_token(uid, tok, done):
    stream[uid] = stream.get(uid, 0) + 1
    if done:
        print(f"  request {uid}: done after {stream[uid]} streamed tokens")


engine = ServeEngine(model, params, slots=2, max_len=64, on_token=on_token, page_size=16)
uids = [engine.submit(p, max_new_tokens=8) for p in prompts]
stats = engine.page_stats
pool = f"{stats['total']}-page pool" if stats else f"{engine.pool_bytes} bytes of rows"
print(f"submitted {len(uids)} requests (prompt lens {[len(p) for p in prompts]}) into 2 slots "
      f"[{engine.cache_kind} cache, {pool}] on {model.device}")

t0 = time.time()
results = engine.run()
dt = time.time() - t0
total = sum(len(v) for v in results.values())
stats = engine.page_stats
print(f"served {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)"
      + (f"; every page back in the pool or held by the prefix cache: "
         f"{stats['free'] + stats.get('cached', 0) == stats['total']}" if stats else ""))

# continuous batching gives the tokens a dedicated generate() call gives
ref = generate(model, params, np.asarray([prompts[0]]), steps=8)
match = results[uids[0]] == ref.cpu().numpy()[0].tolist()
print(f"engine output == per-request generate: {match}")
