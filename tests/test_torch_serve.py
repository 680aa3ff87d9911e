"""The port's ServeEngine against the reference's on the qwen2.5-3b smoke
config: plain paged admission (``prefix_cache=False``), greedy streams
equal token for token, float and EN-T quantized, also on the reduced
qwen2-72b, minicpm-2b (MHA: one q head per kv head) and llava-next-34b
(fed tokens) configs, whose decode reads the paged pool through the same
paged decode op; sampling's truncation equal to the reference's;
temperature > 0 streams replay identically."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro.runtime import sampling as ref_sampling  # noqa: E402
from repro.runtime.serve_loop import ServeEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

SLOTS, MAX_LEN, NEW = 3, 48, 6


# (arch, quantized) of the greedy-stream test; qwen2.5-3b's cases keep
# their ids
STREAM_CASES = [(arch, quantized) for arch in ("qwen2.5-3b", "qwen2-72b", "minicpm-2b",
                                               "llava-next-34b") for quantized in (False, True)]
STREAM_IDS = [str(q) if a == "qwen2.5-3b" else f"{a}-{q}" for a, q in STREAM_CASES]


@functools.lru_cache(maxsize=None)
def _arch_setup(arch):
    cfg = reduced_config(get_config(arch))
    params = ref_build(cfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in (5, 11, 3, 16, 9, 14)]
    return cfg, params, prompts


@pytest.fixture(scope="module")
def setup():
    return _arch_setup("qwen2.5-3b")


def _port_engine(params, arch="qwen2.5-3b", **kw):
    model = Model(port_reduced(port_get_config(arch)), device="cpu")
    return ServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                       prefix_cache=False, **kw)


def _submit_all(engine, prompts, **kw):
    for p in prompts:
        engine.submit(p, max_new_tokens=NEW, **kw)
    return engine.run()


@pytest.mark.parametrize("arch,quantized", STREAM_CASES, ids=STREAM_IDS)
def test_greedy_streams_equal_reference(arch, quantized):
    cfg, params, prompts = _arch_setup(arch)
    if quantized:
        params = ref_quantize(params, QuantConfig(enabled=True))
    ref = RefEngine(ref_build(cfg), params, slots=SLOTS, max_len=MAX_LEN,
                    prefix_cache=False)
    want = _submit_all(ref, prompts)
    eng = _port_engine(bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                       arch)
    streamed = []
    eng.on_token = lambda uid, tok, done: streamed.append((uid, tok, done))
    got = _submit_all(eng, prompts)
    assert got == want
    assert all(len(v) == NEW for v in got.values())
    assert [t for u, t, _ in streamed if u == 2] == got[2]
    eng.check_leaks()
    assert eng.page_stats["free"] == eng.page_stats["total"]


def test_truncate_matches_reference_exactly():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, 257)) * 3).astype(np.float32)
    logits[0, :5] = logits[0, 5]                      # ties
    for top_k, top_p in [(None, 0.9), (8, None), (20, 0.5), (None, 0.3)]:
        want = np.asarray(ref_sampling._truncate(jnp.asarray(logits), top_k, top_p))
        got = sampling._truncate(torch.from_numpy(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(got, want)


def test_temperature_streams_replay_identically(setup):
    _, params, prompts = setup
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    kw = dict(temperature=0.8)
    a = _submit_all(_port_engine(port_params, top_k=20, top_p=0.9, seed=5), prompts, **kw)
    b = _submit_all(_port_engine(port_params, top_k=20, top_p=0.9, seed=5), prompts, **kw)
    assert a == b
    # slot placement and neighbours do not matter: one slot, one at a time
    model = Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu")
    single = ServeEngine(model, port_params, slots=1, max_len=MAX_LEN, seed=5,
                         top_k=20, top_p=0.9, prefix_cache=False)
    assert _submit_all(single, prompts, **kw) == a
    greedy = _submit_all(_port_engine(port_params, seed=5), prompts)
    assert a != greedy        # the temperature really sampled
    c = _submit_all(_port_engine(port_params, top_k=20, top_p=0.9, seed=6), prompts, **kw)
    assert c != a


def test_unported_options_raise(setup):
    _, params, _ = setup
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    model = Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu")
    for kw in ({"prefix_cache": "auto"}, {"prefix_cache": True},
               {"prefix_cache": False, "draft_model": model},
               {"prefix_cache": False, "cache_kind": "dense"}):
        with pytest.raises(NotImplementedError):
            ServeEngine(model, port_params, **kw)


def test_cancel_and_pool_pressure_stay_leak_free(setup):
    _, params, prompts = setup
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    eng = _port_engine(port_params, pages=6)      # 2 requests' worth: stalls
    uids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.step()
    assert eng.cancel(uids[0]) and eng.cancel(uids[-1])
    eng.check_leaks()
    out = eng.run()
    assert set(out) == set(uids[1:-1])
    assert eng.page_stats["free"] == 6


def test_launch_serve_cpu_smoke(capsys):
    port_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--engine", "--quantize",
                     "--no-prefix-cache", "--device", "cpu", "--batch", "2",
                     "--steps", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "served 4 ragged requests" in out and "16 tokens" in out
