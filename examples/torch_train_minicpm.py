"""End-to-end training on the PyTorch port: reduced MiniCPM with its WSD
schedule, checkpointing, and a simulated mid-run restart (port of
``examples/train_minicpm.py``).

    PYTHONPATH=src python examples/torch_train_minicpm.py [--steps 200] [--device cpu]

A ~1M-parameter widening of the reduced config trains for ``--steps``
steps, saving every 50; at half way it "crashes": it waits for the last
save, restores the newest checkpoint, seeks the data stream to its step
and starts a new prefetcher, then trains on to the end.  It crashes
once: the reference's loop crashes again each time it passes the crash
step, so it ends only when that step is a checkpoint step (as at its
default of 200 steps).  Runs on the
CUDA card unless ``--device cpu``.
"""

import argparse
import shutil
import tempfile
from dataclasses import replace

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_optim, reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticSource, TokenStream
from repro_torch.launch.train import build, to_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"], help="default: cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config("minicpm-2b"))
    # widen a bit so there is something to learn (~1M params)
    cfg = replace(cfg, d_model=128, num_heads=4, num_kv_heads=4, d_ff=512,
                  num_layers=4, head_dim=32)
    ocfg = replace(get_optim("minicpm-2b"), lr=3e-3, warmup_steps=20,
                   total_steps=args.steps)
    print(f"model={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"schedule={ocfg.schedule} (MiniCPM WSD)")

    tcfg = TrainConfig(seq_len=args.seq, global_batch=args.batch, checkpoint_every=50)
    model, params, opt, step = build(cfg, tcfg, ocfg, seed=0, device=args.device)

    ckdir = tempfile.mkdtemp(prefix="repro_torch_minicpm_")
    ck = Checkpointer(ckdir)
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=42),
                         global_batch=args.batch, seq_len=args.seq)
    pf = Prefetcher(stream, depth=2)

    crash_at = args.steps // 2
    crashed = False
    losses = []   # (step, loss) of every step run: those after the restored
    #              checkpoint and up to the crash run twice
    s = 0
    try:
        while s < args.steps:
            batch = to_device(pf.next(), model.device)
            params, opt, m = step(params, opt, batch)
            s += 1
            losses.append((s, float(m["loss"])))
            if s % 20 == 0:
                print(f"step {s:4d}  loss {losses[-1][1]:.4f}  "
                      f"lr {m['lr']:.2e}  gnorm {float(m['grad_norm']):.2f}")
            if s % tcfg.checkpoint_every == 0:
                ck.save(s, {"params": params, "opt": opt})
            if s == crash_at and not crashed:
                crashed = True
                print(f"--- simulating failure at step {s}: restoring latest "
                      "checkpoint and resuming ---")
                ck.wait()
                rs, state = ck.restore_latest({"params": params, "opt": opt})
                params, opt = state["params"], state["opt"]
                pf.close()
                stream.seek(rs)
                pf = Prefetcher(stream, depth=2)
                s = rs
    finally:
        ck.wait()
        pf.close()
    print(f"done; checkpoints in {ckdir}")
    shutil.rmtree(ckdir, ignore_errors=True)
    return losses


if __name__ == "__main__":
    main()
