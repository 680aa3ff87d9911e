"""Speculative decoding and the dense engine backend, port against the
reference, on reduced qwen2.5-3b (weights from the reference through
``bridge``):

* ``Model.verify_step``'s logits on dense rows, paged pools and paged
  int8 KV, within FLOAT_TOL: the same float32 math in other summation
  orders (torch vs XLA einsums), amplified by two layers and the LM head,
  as ``tests/test_torch_model.py`` states it; the greedy tokens equal;
* ``greedy_verify`` exactly, on the same numpy logits;
* the deterministic parts of ``spec_verify``'s rejection mode, exactly:
  the truncated tempered logits and the residual with the draft
  excluded; the target's probability of each draft within 1e-6 relative
  (torch's and XLA's float32 ``exp`` may differ in the last bit);
* the port's spec engine streams equal the reference spec engine's,
  token for token at temperature 0: a divergent drafter on the paged
  backend (with the prefix cache, the default) and on the dense one, and
  EN-T records;
* the port's dense engine equals the reference's dense engine.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

FLOAT_TOL = 1e-4
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
NEW = 8


@functools.lru_cache(maxsize=None)
def _ref_params(seed, quantized=False):
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(seed))
    if quantized:
        params = ref_quantize(params, QuantConfig(enabled=True))
    return cfg, params


def _port(params):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _port_model(**kw):
    return Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu", **kw)


@pytest.mark.parametrize("kind,kv_quant", [("dense", False), ("paged", False),
                                           ("paged", True)])
def test_verify_step_logits_match_reference(kind, kv_quant):
    cfg, params = _ref_params(0)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    burst = rng.integers(1, cfg.vocab_size, (2, 5)).astype(np.int32)
    kw = {"page_size": 4} if kind == "paged" else {}
    ref = ref_build(cfg, kv_quant=kv_quant)
    _, c0 = ref.prefill(params, ref.init_cache(2, 32, kind=kind, **kw),
                        tokens=jnp.asarray(toks))
    c0["pos"] = jnp.asarray([6, 6], jnp.int32)
    want, _, _ = ref.verify_step(params, c0, tokens=jnp.asarray(burst))
    model = _port_model(kv_quant=kv_quant)
    _, c = model.prefill(_port(params), model.init_cache(2, 32, kind=kind, **kw),
                         torch.from_numpy(toks).long())
    c["pos"] = torch.tensor([6, 6], dtype=torch.int32)
    got, c1, _ = model.verify_step(_port(params), c, torch.from_numpy(burst).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_TOL, rtol=FLOAT_TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
    assert c1["pos"].tolist() == [11, 11]


def _logits_and_draft(seed, b=3, s=5, v=64):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, s, v)) * 3).astype(np.float32)
    draft = np.argmax(logits, -1)[:, :s - 1].astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % v
    draft[2, 0] = (draft[2, 0] + 5) % v
    return logits, draft


def test_greedy_verify_matches_reference():
    logits, draft = _logits_and_draft(0)
    wt, wn = ref_sampling.greedy_verify(jnp.asarray(logits), jnp.asarray(draft))
    gt, gn = sampling.greedy_verify(torch.from_numpy(logits), torch.from_numpy(draft))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert gn.tolist() == [4, 2, 0]


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None), (None, 0.7), (20, 0.5)])
def test_rejection_parts_match_reference(top_k, top_p):
    """What spec_verify's rejection mode computes before it draws: the
    body of the reference's spec_verify (:165-175) on the same logits."""
    logits, draft = _logits_and_draft(1)
    temp = np.asarray([0.8, 1.5, 0.0], np.float32)
    b, s, v = logits.shape
    tsafe = jnp.where(jnp.asarray(temp) > 0, jnp.asarray(temp), 1.0)
    flat = jnp.asarray(logits).reshape(b * s, v)
    lt = ref_sampling._truncate(flat / jnp.repeat(tsafe, s)[:, None], top_k, top_p)
    lt = lt.reshape(b, s, v)
    probs = jax.nn.softmax(lt, axis=-1)
    p_draft = jnp.take_along_axis(probs[:, :-1], jnp.asarray(draft)[..., None], -1)[..., 0]
    res = jnp.where(jax.nn.one_hot(jnp.asarray(draft), v, dtype=bool), ref_sampling._NEG_INF,
                    lt[:, :-1])
    glt, gp, gres = sampling.rejection_parts(torch.from_numpy(logits), torch.from_numpy(draft),
                                             torch.from_numpy(temp), top_k, top_p)
    np.testing.assert_array_equal(glt.numpy(), np.asarray(lt))
    np.testing.assert_array_equal(gres.numpy(), np.asarray(res))
    np.testing.assert_allclose(gp.numpy(), np.asarray(p_draft), rtol=1e-6, atol=0)


def _ref_serve(params, spec_params=None, **kw):
    cfg = reduced_config(get_config("qwen2.5-3b"))
    model = ref_build(cfg)
    spec = {} if spec_params is None else dict(draft_model=model, draft_params=spec_params,
                                               spec_k=4)
    eng = RefEngine(model, params, slots=2, max_len=64, **spec, **kw)
    uids = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    res = eng.run()
    return [res[u] for u in uids]


def _port_serve(params, spec_params=None, **kw):
    model = _port_model()
    spec = {} if spec_params is None else dict(draft_model=model, draft_params=spec_params,
                                               spec_k=4)
    eng = ServeEngine(model, params, slots=2, max_len=64, **spec, **kw)
    uids = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    res = eng.run()
    eng.check_leaks()
    return [res[u] for u in uids], eng


@pytest.mark.parametrize("kind,quantized", [("paged", False), ("dense", False),
                                            ("paged", True)],
                         ids=["paged", "dense", "EN-T"])
def test_spec_streams_match_reference(kind, quantized):
    _, params = _ref_params(0, quantized)
    _, draft = _ref_params(1)
    want = _ref_serve(params, draft, cache_kind=kind)
    got, eng = _port_serve(_port(params), _port(draft), cache_kind=kind)
    assert got == want
    assert eng.spec_stats["ticks"] > 0 and all(len(o) == NEW for o in got)


def test_dense_engine_matches_reference():
    _, params = _ref_params(0)
    want = _ref_serve(params, cache_kind="dense")
    got, eng = _port_serve(_port(params), cache_kind="dense")
    assert got == want and eng.cache_kind == "dense"
