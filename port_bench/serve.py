"""The serving driver: a configuration with ``"driver": "serve"`` under a
traffic file whose kind (``traffic/<generator>.py``) provides ``Arrivals``.

Set-up builds the kernels the configuration names, makes the weights from
the seed (``weights.py``), hands them to the program, which quantizes them
layer by layer (``repro_torch.quant.quantize_params``), and builds the
engine and the front end (``ServeEngine`` under ``PipelinedScheduler``)
at the traffic file's sizes.  The requests the traffic starts with are
sent; the window opens once every one of them has had its first token,
so (in a closed loop) every slot has been admitted and every shape of
the cell has run.  After each tick the driver sends what the traffic
sends then: in a closed loop, a client's next request as soon as the
tick that finished its last one returns; requests due on a timer, by the
seconds since the first was sent.

What the run keeps for the metric readers (``Observed``): each request's
client-side times (submit, every token), each prefill chunk and decode
call as the scheduler made them (timed on the host at dispatch, with
their rows and positions), and each tick's host span.

Once the window has closed and the program's state is freed, the check
runs the reference (``reference/<config's reference>.py``) over a sample
drawn from the seed of the requests finished in the window, the longest
prompt among them included, and reads the widest gap by which a served
token's reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from port_bench import weights as W
from port_bench.program import build_kernels, model_config
from port_bench.trace import Spans
from port_bench.traffic import generator


@dataclass
class Req:
    client: int
    prompt: list
    max_new: int
    spec: object = None            # the traffic's own Request
    submit: float = 0.0
    times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    done: float | None = None


@dataclass
class Observed:
    t_open: float = 0.0
    t_close: float = 0.0
    requests: list = field(default_factory=list)
    chunks: list = field(default_factory=list)     # (t, rows, real rows, pos0)
    decodes: list = field(default_factory=list)    # (t, rows, live rows, cached rows)
    ticks: list = field(default_factory=list)      # (t0, t1)

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.obs = Observed()
        self.span = Spans()
        self.built = []

    # .. set-up ..
    def setup(self):
        from repro_torch.configs.base import QuantConfig
        from repro_torch.models.transformer import build_model
        from repro_torch.quant.quantize import quantize_params
        from repro_torch.runtime.scheduler import PipelinedScheduler
        from repro_torch.runtime.serve_loop import ServeEngine

        cfg, tr, dev = self.cell.cfg, self.cell.traffic, self.device
        self.built = build_kernels(cfg, dev)
        model = build_model(model_config(cfg), device=dev, use_kernels=True,
                            kv_quant=bool(cfg.get("kv_quant")))
        q = cfg.get("quant", {})
        qcfg = QuantConfig(**q) if q.get("enabled") else None
        params = W.top(cfg, self.seed, dev)
        layers = []
        for i in range(cfg["model"]["num_layers"]):
            layer = W.layer(cfg, self.seed, i, dev)
            layers.append(quantize_params(layer, qcfg, f"/layers/{i}") if qcfg else layer)
        params["layers"] = layers
        e = tr["engine"]
        self.engine = ServeEngine(model, params, slots=e["slots"], max_len=e["max_len"],
                                  page_size=e["page_size"], prefill_chunk=e["prefill_chunk"],
                                  prefix_cache=e["prefix_cache"],
                                  seed=generator.derive(self.seed, 5) % (1 << 31))
        self.sched = PipelinedScheduler(self.engine, pipeline_depth=e["pipeline_depth"],
                                        max_queue=e["max_queue"],
                                        prefill_chunk=e["prefill_chunk"])
        self._instrument(model)
        self.arrivals = generator.kind(tr).Arrivals(tr, self.seed, cfg["model"]["vocab_size"])
        self.t_first = None
        self.finished: list[Req] = []
        self.live: dict[int, Req] = {}

    def _instrument(self, model):
        """Host spans and work records around the model's two serving calls."""
        obs, apply, decode = self.obs, model.apply, model.decode_step

        def chunk(params, tokens=None, **kw):
            if not kw.get("write_cache"):
                return apply(params, tokens, **kw)
            rows = tokens.shape[0] * tokens.shape[1]
            last = kw.get("last_index")
            obs.chunks.append((time.perf_counter(), rows,
                               rows if last is None else last + 1, int(kw.get("pos0", 0))))
            with self.span("chunk"):
                return apply(params, tokens, **kw)

        def step(params, cache, tokens=None, **kw):
            live = [r for r in self.live.values() if r.times]
            obs.decodes.append((time.perf_counter(), int(tokens.shape[0]), len(live),
                                sum(len(r.prompt) + len(r.tokens) for r in live)))
            with self.span("decode"):
                return decode(params, cache, tokens, **kw)

        model.apply, model.decode_step = chunk, step

    # .. requests and ticks ..
    def _send(self, g):
        req = Req(g.client, g.prompt, g.max_new, g)

        def on_token(tok, done, req=req):
            req.times.append(time.perf_counter())
            req.tokens.append(tok)
            if done:
                req.done = req.times[-1]
                self.finished.append(req)

        with self.span("client"):
            req.submit = time.perf_counter()
            if self.t_first is None:
                self.t_first = req.submit
            uid = self.sched.submit(g.prompt, max_new_tokens=g.max_new,
                                    temperature=float(self.cell.traffic.get("temperature", 0.0)),
                                    on_token=on_token)
        if uid is None:
            raise RuntimeError("the scheduler shed a request of the traffic")
        self.live[uid] = req
        self.obs.requests.append(req)

    def _tick(self):
        t0 = time.perf_counter()
        with self.span("tick"):
            self.sched.tick()
        self.obs.ticks.append((t0, time.perf_counter()))
        done, self.finished = self.finished, []
        elapsed = time.perf_counter() - self.t_first
        for req in done:
            self.live = {u: r for u, r in self.live.items() if r is not req}
            for g in self.arrivals.after(req.spec, elapsed):
                self._send(g)
        for g in self.arrivals.due(elapsed):
            self._send(g)

    def warm(self):
        """The traffic's first requests, ticked until each has its first
        token."""
        for g in self.arrivals.start():
            self._send(g)
        first = list(self.obs.requests)
        while not all(r.times for r in first):
            self._tick()

    def window(self, seconds: float, tracer):
        with tracer:
            self.obs.t_open = tracer.t0
            while time.perf_counter() < self.obs.t_open + seconds:
                self._tick()
            self.obs.t_close = time.perf_counter()

    def free(self):
        errors = dict(self.sched.errors)
        del self.sched, self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return errors

    # .. correct ..
    def sample(self) -> list[Req]:
        """Finished requests of the window drawn from the seed, the longest
        prompt first, until ``sample_tokens`` served tokens."""
        obs = self.obs
        done = [r for r in obs.requests if r.done is not None and obs.in_window(r.done)]
        if not done:
            return []
        longest = max(done, key=lambda r: len(r.prompt))
        rest = [r for r in done if r is not longest]
        order = generator.rng(self.seed, 6).permutation(len(rest))
        picked, served = [longest], len(longest.tokens)
        for i in order:
            if served >= self.cell.check["sample_tokens"]:
                break
            picked.append(rest[i])
            served += len(rest[i].tokens)
        return picked

    def reference_gaps(self, picked: list[Req], levels: int | None = None):
        """Per picked request, the reference's [served] gaps: its best logit
        minus its logit of the served token at each served position; with
        ``levels`` also the gaps of the token that reference at those weight
        levels puts first (the control)."""
        import importlib

        ref = importlib.import_module(f"port_bench.reference.{self.cell.cfg['reference']}")
        seqs = [(r.prompt + r.tokens[:-1],
                 list(range(len(r.prompt) - 1, len(r.prompt) + len(r.tokens) - 1)))
                for r in picked]
        logits = ref.logits_at(self.cell.cfg, self.seed, seqs, self.device)
        ctl = ([None] * len(seqs) if levels is None else
               ref.logits_at(self.cell.cfg, self.seed, seqs, self.device, levels=levels))
        out = []
        for lg, lc, r in zip(logits, ctl, picked):
            best = lg.max(dim=-1).values
            served = torch.as_tensor(r.tokens, device=lg.device)
            gaps = (best - lg.gather(1, served[:, None])[:, 0]).cpu().numpy()
            if lc is not None:
                lc = (best - lg.gather(1, lc.argmax(dim=-1)[:, None])[:, 0]).cpu().numpy()
            out.append((gaps, lc))
        return out


def check(run: Run, errors: dict) -> tuple[dict, int, int]:
    """(numbers compared {name: (value, limit)}, attempted, failed)."""
    obs = run.obs
    in_flight = [r for r in obs.requests if r.done is None]
    done = [r for r in obs.requests if r.done is not None and obs.in_window(r.done)]
    failed = len(errors) + sum(1 for r in done if len(r.tokens) != r.max_new)
    picked = run.sample()
    gaps = run.reference_gaps(picked)
    widest = max((float(g.max()) for g, _ in gaps), default=float("inf"))
    print(f"checked {sum(len(r.tokens) for r in picked)} served tokens of "
          f"{len(picked)} requests", file=sys.stderr)
    numbers = {"logit_gap": (widest, run.cell.check["limits"]["logit_gap"])}
    return numbers, len(done) + len(in_flight), failed


def passes(numbers: dict) -> bool:
    gap, lim = numbers["logit_gap"]
    return bool(np.isfinite(gap) and gap <= lim)


def control(run: Run, seconds: float, dump: str | None = None) -> dict:
    """``control.py``'s readings of one seed: the window of ``seconds``, then
    the program's widest gap and the control's (the reference with int4
    weights in the program's place) over the same sample."""
    from port_bench.trace import Tracer

    run.window(seconds, Tracer(False, run.device, run.span))
    run.free()
    picked = run.sample()
    both = run.reference_gaps(picked, levels=7)
    return {"program": {"logit_gap": max(float(g.max()) for g, _ in both)},
            "control": {"logit_gap": max(float(c.max()) for _, c in both)},
            "served_checked": sum(len(r.tokens) for r in picked),
            "requests_checked": len(picked)}
