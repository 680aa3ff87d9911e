"""The comparison that decides ``correct``, driven through a whole run at a
tiny size on the CPU (the harness's look for a card skipped): a sound run
comes out correct; the control, and each fault the cell can have planted
under the timed path, come out not correct under the cell's own limits.

The tiny configurations keep each cell's kinds of layers and its
precision (bf16 compute, w8a8 records) and the logit scale of the full
widths (the embedding's std scaled by sqrt(d_model))."""

import time

import numpy as np
import pytest
import torch

from port_bench import cell as cells, serve, train
from port_bench.run import run_cell

torch.set_num_threads(1)
CPU = torch.device("cpu")


def tiny_serve():
    c = cells.load("qwen-ent.longdoc")
    c.cfg["model"].update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                          d_ff=128, vocab_size=256)
    c.cfg["weights"]["embed_std"] = 3 * 0.02 * (2048 / 64) ** 0.5
    c.traffic.update(clients=4, requests_per_client=40,
                     prompt_len={"dist": "log_uniform", "lo": 20, "hi": 60},
                     output_len={"dist": "uniform", "lo": 4, "hi": 8})
    c.traffic["engine"].update(slots=4, max_len=128, prefill_chunk=16)
    c.check["sample_tokens"] = 32
    return c


def tiny_train():
    c = cells.load("mamba2.train4k")
    c.cfg["model"].update(num_layers=2, d_model=64, vocab_size=256)
    c.cfg["model"]["ssm"].update(state_dim=16, head_dim=16)
    c.cfg["weights"]["embed_std"] = 0.02 * (1024 / 64) ** 0.5
    c.traffic.update(seq_len=64, global_batch=4, microbatch=2)
    return c


def _run(cell, seed, seconds=2.0):
    return run_cell(cell, seed, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_sound_serving_run_is_correct(seed):
    out = _run(tiny_serve(), seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "serve_tok_s", "itl_p95_ms", "peak_mem_gib"}


def test_served_token_altered_is_not_correct(monkeypatch):
    from repro_torch.runtime import sampling

    real = sampling.greedy
    monkeypatch.setattr(sampling, "greedy", lambda logits: (real(logits) + 1) % 256)
    out = _run(tiny_serve(), 5)
    assert not out["correct"], out["checks"]


def test_serving_control_is_not_correct():
    """The reference with int4 weights in the program's place."""
    c = tiny_serve()
    run = serve.Run(c, 7, CPU)
    run.setup()
    run.warm()
    from port_bench.trace import Tracer

    run.window(2.0, Tracer(False, CPU, run.span))
    run.free()
    both = run.reference_gaps(run.sample(), levels=7)
    program = max(float(g.max()) for g, _ in both)
    control = max(float(k.max()) for _, k in both)
    limit = c.check["limits"]["logit_gap"]
    assert program <= limit < control


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_sound_training_run_is_correct(seed):
    out = _run(tiny_train(), seed)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_tok_s", "peak_mem_gib"}


def test_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.optim import adamw

    def frozen(cfg, grads, state, params, norm=None):
        return params, dict(state, step=state["step"] + 1), {"grad_norm": 0.0, "lr": 0.0}

    monkeypatch.setattr(adamw, "update", frozen)
    out = _run(tiny_train(), 6)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.runtime import train_loop

    real = train_loop._microbatches
    monkeypatch.setattr(train_loop, "_microbatches",
                        lambda batch, mb: real(batch, mb)[: max(1, len(real(batch, mb)) // 2)])
    out = _run(tiny_train(), 8)
    assert not out["correct"], out["checks"]


def test_training_control_is_not_correct():
    """The reference computed in float8 in the program's place."""
    from port_bench.reference.mamba2_lm import to_fp8

    c = tiny_train()
    run = train.Run(c, 9, CPU)
    ref = run.reference()
    got = train.gaps(run.reference(cast=to_fp8), ref)
    lim = c.check["limits"]
    assert any(got[k] > lim[k] for k in lim), got


def test_fp8_rounding_keeps_the_gradient():
    from port_bench.reference.mamba2_lm import to_fp8

    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = to_fp8(x)
    assert not torch.equal(y.detach(), x.detach())
    assert (y.detach() - x.detach()).abs().max() <= 3 * 2**-3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))
    assert np.isfinite(y.detach().numpy()).all()
