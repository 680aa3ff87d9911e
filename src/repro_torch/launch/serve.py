"""Serving entry point of the port: EN-T w8a8 continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --engine --quantize --no-prefix-cache [--smoke] [--device cuda|cpu]

Builds the model at the config's widths (``--smoke``: the reduced
config), draws random weights from ``--seed`` on the device, encodes
every projection into packed EN-T planes layer by layer
(``--quantize``), then serves ``2 * --batch`` ragged requests through
the paged ``ServeEngine``.  Runs on the CUDA card unless ``--device
cpu``.  The one-shot ``generate`` path (no ``--engine``) and the prefix
cache are later slices and are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model, build_model
from repro_torch.runtime.serve_loop import ServeEngine


def build(cfg: ModelConfig, *, quantize: bool = False, seed: int = 0,
          device=None, use_kernels: bool = True, quant: QuantConfig | None = None,
          kv_quant: bool = False) -> tuple[Model, dict]:
    """Model + random params drawn on the device from ``seed``, quantized
    layer by layer with ``quant`` (``quantize``: EN-T, the default
    ``QuantConfig(enabled=True)``; ``QuantConfig(enabled=True,
    ent_encode=False)`` keeps plain w8a8 int8 records).  ``kv_quant``
    serves from an int8 KV cache."""
    dev = resolve_device(device)
    if quant is None and quantize:
        quant = QuantConfig(enabled=True)
    model = build_model(cfg, device=dev, use_kernels=use_kernels, kv_quant=kv_quant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, quant=quant)
    return model, params


def ragged_prompts(rng: np.random.Generator, n: int, lo: int, hi: int,
                   vocab: int) -> list[list[int]]:
    """``n`` prompts with lengths drawn from [lo, hi] and random tokens."""
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(k)).tolist() for k in lens]


def serve(engine: ServeEngine, prompts, *, max_new_tokens: int,
          temperature: float = 0.0):
    """Submit ``prompts`` and drain the engine.  Returns (results
    {uid: tokens}, seconds) with the device synchronised."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new_tokens, temperature=temperature)
    results = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return results, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching ServeEngine (required: the "
                         "one-shot generate path is not ported yet)")
    ap.add_argument("--quantize", action="store_true",
                    help="EN-T w8a8: encode weights once, serve int8")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="radix prefix cache (not ported yet: pass "
                         "--no-prefix-cache)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=0,
                    help="engine batch slots (default: --batch)")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0)
    ap.add_argument("--pages", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("only --engine serving is ported; generate() is a later slice")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    t0 = time.perf_counter()
    model, params = build(cfg, quantize=args.quantize, seed=args.seed,
                          device=args.device)
    print(f"model {cfg.name} on {model.device}: init"
          f"{' + EN-T encode' if args.quantize else ''} "
          f"{time.perf_counter() - t0:.2f}s")
    slots = args.slots or args.batch
    engine = ServeEngine(
        model, params, slots=slots, max_len=2 * args.prompt_len + args.steps + 8,
        prefill_chunk=args.prefill_chunk or None, top_k=args.top_k or None,
        top_p=args.top_p or None, page_size=args.page_size or None,
        pages=args.pages or None, seed=args.seed,
        prefix_cache="auto" if args.prefix_cache is None else args.prefix_cache)
    rng = np.random.default_rng(args.seed)
    prompts = ragged_prompts(rng, 2 * args.batch, max(1, args.prompt_len // 2),
                             args.prompt_len, cfg.vocab_size)
    results, dt = serve(engine, prompts, max_new_tokens=args.steps,
                        temperature=args.temperature)
    total = sum(len(v) for v in results.values())
    lens = [len(p) for p in prompts]
    print(f"engine[paged]: served {len(prompts)} ragged requests (prompt lens "
          f"{min(lens)}..{max(lens)}) on {slots} slots: {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s)")
    ps = engine.page_stats
    print(f"pages: {ps['total']} total, {ps['free']} free, "
          f"{ps['resident']} resident; KV pools {engine.pool_bytes / 2**20:.2f} MiB")
    print("sample:", results[min(results)][:16])


if __name__ == "__main__":
    main()
