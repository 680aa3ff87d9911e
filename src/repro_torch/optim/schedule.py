"""LR schedules: linear warmup into cosine / WSD / linear decay (port of
``repro/optim/schedule.py``).

WSD (warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395):
constant LR after warmup, then a decay over the final ``wsd_decay_frac``
of training, linear in log to 10% of peak.  The arithmetic is float32,
as the reference's, on the host.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import OptimConfig


def lr_at(cfg: OptimConfig, step) -> float:
    f = np.float32
    step, one = f(step), f(1.0)
    warm = (np.minimum(step / f(cfg.warmup_steps), one)
            if cfg.warmup_steps > 0 else one)
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0.0), one)
    if cfg.schedule == "cosine":
        decay = f(0.5) * (one + np.cos(f(np.pi) * t)) * f(0.9) + f(0.1)
    elif cfg.schedule == "wsd":
        start = f(1.0 - cfg.wsd_decay_frac)
        d = np.clip((t - start) / f(cfg.wsd_decay_frac), f(0.0), one)
        decay = np.exp(d * np.log(f(0.1)))      # 1.0 -> 0.1 exponentially
    elif cfg.schedule == "linear":
        decay = one - f(0.9) * t
    else:
        raise ValueError(cfg.schedule)
    return float(f(cfg.lr) * warm * decay)
