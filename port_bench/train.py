"""The training driver: a configuration with ``"driver": "train"`` under a
traffic file whose kind (``traffic/<generator>.py``) provides ``batch``.

Set-up builds the kernels the configuration names, makes the float32
master weights from the seed (``weights.py``) and hands them to the
program's train step (``repro_torch.runtime.train_loop.make_train_step``
at the configuration's remat and optimizer, the traffic file's sequence,
batch and microbatch), which updates them in place.  That same step then
runs the first ``check_steps`` steps, each on a fresh batch: they warm
every shape, and their readings are what the check compares: each step's
loss, the norm of each leaf's first gradient as the optimizer took it
(its first moment after one step over 1 - beta1) and the norm of each
leaf's change after the last of them.

The window runs the same step back to back on fresh batches, each
followed by a device synchronisation, and closes at the end of the first
step that ends past ``--seconds``: the window is a whole number of steps.

Once the window has closed and the program's state is freed, the
reference (``reference/<config's reference>.py``) trains the same weights
on the same batches for the same steps, and the check reads, for the first
gradient's norms and for the change's norms, the widest leaf's gap and
the median leaf's, each over the larger of the reference's norm of that
leaf and of the median leaf, and holds each against its limit in
``checks/<cell>.json`` (the step losses' widest relative gap is read and
printed, and compared only where the file gives it a limit).  The change
leaves out leaves whose reference gradient is under a thousandth of the
median leaf's: Adam moves those by round-off alone.
"""

from __future__ import annotations

import gc
import importlib
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from port_bench import weights as W
from port_bench.program import build_kernels, model_config
from port_bench.reference.mamba2_lm import paths
from port_bench.trace import Spans
from port_bench.traffic import generator


@dataclass
class Observed:
    t_open: float = 0.0
    t_close: float = 0.0
    steps: list = field(default_factory=list)      # (t0, t1, tokens)


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.obs = Observed()
        self.span = Spans()
        self.built = []
        self.readings = {}

    def _batch(self, step: int):
        tr = self.cell.traffic
        toks = generator.kind(tr).batch(tr, self.seed, self.cell.cfg["model"]["vocab_size"], step)
        t = torch.from_numpy(toks).to(self.device, dtype=torch.int64)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def setup(self):
        from repro_torch.configs.base import OptimConfig, TrainConfig
        from repro_torch.models.transformer import build_model
        from repro_torch.runtime.train_loop import init_opt_state, make_train_step

        cfg, tr, dev = self.cell.cfg, self.cell.traffic, self.device
        self.built = build_kernels(cfg, dev)
        tcfg = TrainConfig(seq_len=tr["seq_len"], global_batch=tr["global_batch"],
                           microbatch=tr["microbatch"], remat=cfg["train"]["remat"])
        self.ocfg = OptimConfig(**cfg["train"]["optim"])
        model = build_model(model_config(cfg), device=dev)
        apply = model.apply

        def forward(*a, **kw):
            with self.span("forward"):
                return apply(*a, **kw)

        model.apply = forward
        self.params = W.full(cfg, self.seed, dev)
        self.opt = init_opt_state(tcfg, self.params)
        self.step_fn = make_train_step(model, self.ocfg, tcfg)
        self.next_step = 0

    def _step(self):
        batch = self._batch(self.next_step)
        self.next_step += 1
        with self.span("step"):
            self.params, self.opt, m = self.step_fn(self.params, self.opt, batch)
        return m

    def warm(self):
        """The first ``check_steps`` steps, with the check's readings."""
        n = int(self.cell.check["check_steps"])
        losses = []
        for s in range(n):
            m = self._step()
            losses.append(m["loss"])
            if s == 0:
                b1 = self.ocfg.beta1
                grads = [(p, (t / (1 - b1)).norm()) for p, t in paths(self.opt["adam"]["m"])]
        start = paths(W.full(self.cell.cfg, self.seed, self.device))
        now = dict(paths(self.params))
        change = [(p, (now[p].detach() - t0).norm()) for p, t0 in start]
        del start, now
        self.readings = {"loss": [float(v) for v in losses],
                         "grad": {p: float(v) for p, v in grads},
                         "change": {p: float(v) for p, v in change}}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer):
        tokens = self.cell.traffic["global_batch"] * self.cell.traffic["seq_len"]
        with tracer:
            self.obs.t_open = t = tracer.t0
            while t < self.obs.t_open + seconds:
                self._step()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t1 = time.perf_counter()
                self.obs.steps.append((t, t1, tokens))
                t = t1
            self.obs.t_close = t

    def free(self):
        del self.params, self.opt, self.step_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {}

    def reference(self, **kw) -> dict:
        ref = importlib.import_module(f"port_bench.reference.{self.cell.cfg['reference']}")
        n = int(self.cell.check["check_steps"])
        tr = self.cell.traffic
        batches = [generator.kind(tr).batch(tr, self.seed, self.cell.cfg["model"]["vocab_size"], s)
                   for s in range(n)]
        return ref.train(self.cell.cfg, self.seed, batches, self.cell.traffic["microbatch"],
                         self.device, **kw)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers the check reads (see the module docstring): the widest
    relative gap of the step losses; of the first gradient's and of the
    change's norms, the widest leaf's gap and the median leaf's, each
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    gmed = statistics.median(ref["grad"].values())
    moved = [p for p, g in ref["grad"].items() if g >= 1e-3 * gmed]
    for key, leaves in (("grad", list(ref["grad"])), ("change", moved)):
        med = statistics.median(ref[key][p] for p in leaves)
        rel = [abs(prog[key][p] - ref[key][p]) / max(ref[key][p], med) for p in leaves]
        out[f"{key}_gap"] = max(rel)
        out[f"{key}_gap_median"] = statistics.median(rel)
    return out


def check(run: Run, errors: dict) -> tuple[dict, int, int]:
    ref = run.reference()
    got = gaps(run.readings, ref)
    lim = run.cell.check["limits"]
    for k, v in got.items():
        if k not in lim:
            print(f"read, not compared: {k} {v!r}", file=sys.stderr)
    numbers = {k: (v, lim[k]) for k, v in got.items() if k in lim}
    return numbers, len(run.obs.steps), 0


def passes(numbers: dict) -> bool:
    return all(v == v and v <= lim for v, lim in numbers.values())


def worst_leaves(got: dict, ref: dict, n: int = 4) -> dict:
    """The ``n`` leaves with the widest gaps of the first gradient's and the
    change's norms (as ``gaps`` weighs them), for the look at what sets
    each number."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        g = sorted(((abs(got[key][p] - v) / max(v, med), p) for p, v in ref[key].items()),
                   reverse=True)
        out[key] = [[p, round(x, 5), ref[key][p] / med] for x, p in g[:n]]
    return out


def control(run: Run, seconds: float, dump: str | None = None) -> dict:
    """``control.py``'s readings of one seed (no window: the set-up's steps
    are what is compared): the program, the control (the reference
    computed in float8 e4m3) and the fault "half of the batch left out, the
    mean taken over the rest", each against the float32 reference."""
    import json

    from port_bench.reference.mamba2_lm import to_fp8

    run.free()
    ref = run.reference()
    b = run.cell.traffic["global_batch"]
    ctl = run.reference(cast=to_fp8)
    half = run.reference(rows=slice(0, b // 2))
    if dump:
        with open(f"{dump}/leaves_{run.seed}.json", "w") as f:
            json.dump({"program": run.readings, "reference": ref, "control": ctl,
                       "half_batch": half}, f)
    return {"program": gaps(run.readings, ref),
            "control": gaps(ctl, ref),
            "half_batch": gaps(half, ref),
            "losses": {"program": run.readings["loss"], "reference": ref["loss"],
                       "control": ctl["loss"], "half_batch": half["loss"]},
            "worst": {"program": worst_leaves(run.readings, ref),
                      "control": worst_leaves(ctl, ref)}}
