"""Training entry point of the port (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 3 --seq 4096 --batch 2 --microbatch 1 --remat full \\
        [--smoke] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 3 --seq 4096 --batch 8 --microbatch 4 --remat full

Wires together: config registry -> model with random float32 master
weights from a seed, drawn on the device -> train step (microbatch
accumulation, remat, AdamW with the arch's schedule) -> deterministic
synthetic token stream (``SyntheticSource(seed=1234)``, as the
reference) with a prefetch thread.  Prints the reference's per-step line
(loss, lr, grad-norm, tokens/s).  Runs on the CUDA card unless
``--device cpu``; ``--smoke`` takes the reduced config (seq <= 128,
batch <= 8).  One device only: ``--mesh`` other than ``1x1`` and
``--ckpt`` (the checkpointer) are later slices and are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_optim, reduced_config
from repro_torch.configs.base import ModelConfig, OptimConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticSource, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.runtime.train_loop import init_opt_state, make_train_step


def build(cfg: ModelConfig, tcfg: TrainConfig, ocfg: OptimConfig, *,
          seed: int = 0, device=None):
    """(model, params, optimizer state, train step): float32 master weights
    drawn on the device from ``seed``."""
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen)
    return model, params, init_opt_state(tcfg, params), make_train_step(model, ocfg, tcfg)


def to_device(batch, device):
    """{"tokens", "labels"} numpy batch -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device,
                                                            dtype=torch.int64)
            for k, v in batch.items()}


def train(step_fn, params, opt, source, steps: int, *, device,
          log_every: int = 10, on_step=None):
    """Run ``steps`` steps on batches from ``source.next()``.
    Each step's time runs from fetching its batch to its loss on the host
    (which waits for the device).  ``on_step(record)`` sees each step's
    record {"step", "loss", "lr", "grad_norm", "seconds", "tokens_per_s"}.
    Returns (params, opt, records)."""
    records = []
    for s in range(steps):
        t0 = time.perf_counter()
        batch = to_device(source.next(), device)
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        tokens = batch["tokens"].numel()
        rec = {"step": s + 1, "loss": loss, "lr": m["lr"],
               "grad_norm": float(m["grad_norm"]), "seconds": dt,
               "tokens_per_s": tokens / max(dt, 1e-9)}
        if (s + 1) % log_every == 0:
            print(f"step {s + 1:5d} loss {loss:.4f} lr {rec['lr']:.2e} "
                  f"gnorm {rec['grad_norm']:.2f} tok/s {rec['tokens_per_s']:,.0f}",
                  flush=True)
        if on_step is not None:
            on_step(rec)
        records.append(rec)
    return params, opt, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only: multi-device training is not ported yet")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="full", choices=("none", "full", "dots"))
    ap.add_argument("--ckpt", default="",
                    help="not ported yet: the checkpointer is a later slice")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-device training is not ported yet; "
            "use --mesh 1x1")
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt: the checkpointer is not ported yet")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
        args.seq = min(args.seq, 128)
        args.batch = min(args.batch, 8)
    ocfg = get_optim(args.arch)
    tcfg = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                       microbatch=args.microbatch, remat=args.remat)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e9:.2f}B "
          f"mesh=(1, 1) remat={args.remat} device={device}", flush=True)
    _, params, opt, step_fn = build(cfg, tcfg, ocfg, seed=0, device=device)
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=1234),
                         global_batch=args.batch, seq_len=args.seq)
    pf = Prefetcher(stream, depth=2)
    try:
        _, _, records = train(step_fn, params, opt, pf, args.steps, device=device,
                              log_every=args.log_every)
    finally:
        pf.close()
    return records


if __name__ == "__main__":
    main()
