"""Batched prefill ≡ sequential decode, bit for bit, on the port's plain
path (the port's counterpart of ``tests/test_serve_engine.py``'s
``TestBatchedPrefillParity``).

``Model.prefill`` over a prompt must give exactly the logits and the
cache state (every K / V row, int8 code and scale, the block table,
``pos`` and ``start``) that stepping the prompt through ``decode_step``
token by token gives, for dense and paged caches, float and int8 KV,
uniform and ragged left-padded batches; left padding must be invisible
(each ragged row's logits equal its own unpadded prefill).  The model is
the reduced qwen2.5-3b in float32 with the reference's weights, bridged
through numpy; its prefill logits are also held against the reference's
to the 1e-4 of ``tests/test_torch_model.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.models import kv_cache  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

B, S0, MAX_LEN = 2, 10, 16
LENS = [10, 6, 3]
FLOAT_TOL = 1e-4   # as tests/test_torch_model.py: f32 in another order
KINDS = ["dense", "paged"]


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, port_params


def _model(kv_quant=False):
    return Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu",
                 kv_quant=kv_quant)


def _tokens(seed, b, vocab, lens=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, S0)).astype(np.int64)
    mask = None
    if lens is not None:
        mask = np.arange(S0)[None, :] >= (S0 - np.asarray(lens)[:, None])
        toks = np.where(mask, toks, 0)
        mask = torch.from_numpy(mask)
    return torch.from_numpy(toks), mask


def _sequential_prefill(model, params, toks, kind, mask=None, start=None):
    cache = model.init_cache(toks.shape[0], MAX_LEN, kind=kind)
    if start is not None:
        cache["start"] = start
    logits = None
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(
            params, cache, toks[:, t],
            token_mask=None if mask is None else mask[:, t])
    return logits, cache


def _cache_tensors(cache):
    """name -> every tensor of the cache state (and pos / start)."""
    out = {"pos": torch.as_tensor(cache["pos"])}
    if "start" in cache:
        out["start"] = cache["start"]
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v", "k_s", "v_s", "block_table"):
            t = getattr(layer, name, None)
            if t is not None:
                out[f"layers/{i}/{name}"] = t
    return out


def _assert_bit_identical(la, ca, lb, cb):
    assert torch.equal(la, lb), float((la - lb).abs().max())
    ta, tb = _cache_tensors(ca), _cache_tensors(cb)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert ta[name].dtype == tb[name].dtype, name
        assert torch.equal(ta[name], tb[name]), (
            name, float((ta[name].double() - tb[name].double()).abs().max()))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("kind", KINDS)
def test_uniform_batch_bit_identical(setup, kind, kv_quant):
    cfg, _, params = setup
    model = _model(kv_quant)
    toks, _ = _tokens(7, B, cfg.vocab_size)
    la, ca = model.prefill(params, model.init_cache(B, MAX_LEN, kind=kind), toks)
    lb, cb = _sequential_prefill(model, params, toks, kind)
    _assert_bit_identical(la, ca, lb, cb)
    assert ca["pos"] == S0
    if kv_quant:
        assert ca["layers"][0].k.dtype == torch.int8


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("kind", KINDS)
def test_ragged_padded_batch_bit_identical(setup, kind, kv_quant):
    cfg, _, params = setup
    model = _model(kv_quant)
    toks, mask = _tokens(3, len(LENS), cfg.vocab_size, LENS)
    la, ca = model.prefill(params, model.init_cache(len(LENS), MAX_LEN, kind=kind),
                           toks, pad_mask=mask)
    start = (S0 - torch.tensor(LENS)).to(torch.int32)
    lb, cb = _sequential_prefill(model, params, toks, kind, mask=mask, start=start)
    _assert_bit_identical(la, ca, lb, cb)
    assert torch.equal(ca["start"], start)


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_rows_match_unpadded_prefill(setup, kind):
    """Left padding is invisible: each ragged row's last-token logits equal
    a prefill of that row alone, unpadded."""
    cfg, _, params = setup
    model = _model()
    toks, mask = _tokens(5, len(LENS), cfg.vocab_size, LENS)
    la, _ = model.prefill(params, model.init_cache(len(LENS), MAX_LEN, kind=kind),
                          toks, pad_mask=mask)
    for i, n in enumerate(LENS):
        li, _ = model.prefill(params, model.init_cache(1, MAX_LEN, kind=kind),
                              toks[i:i + 1, S0 - n:])
        assert torch.equal(li[0], la[i]), (i, float((li[0] - la[i]).abs().max()))


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_prefill_bit_identical(setup, kind):
    """Cache-write-through chunks of 4 give the one-shot prefill's logits
    and cache."""
    cfg, _, params = setup
    model = _model()
    toks, _ = _tokens(11, B, cfg.vocab_size)
    la, ca = model.prefill(params, model.init_cache(B, MAX_LEN, kind=kind), toks)
    lb, cb = model.prefill(params, model.init_cache(B, MAX_LEN, kind=kind), toks,
                           chunk=4)
    _assert_bit_identical(la, ca, lb, cb)


def test_token_mask_is_checked(setup):
    """``decode_step(token_mask=)`` marks pad tokens: attention layers mask
    them through ``start`` alone, so the mask leaves the step unchanged;
    a mask of the wrong shape or dtype raises."""
    cfg, _, params = setup
    model = _model()
    toks, _ = _tokens(13, B, cfg.vocab_size)
    la, _ = model.decode_step(params, model.init_cache(B, MAX_LEN), toks[:, 0])
    lb, _ = model.decode_step(params, model.init_cache(B, MAX_LEN), toks[:, 0],
                              token_mask=torch.tensor([True, False]))
    assert torch.equal(la, lb)
    for bad in (torch.ones(B + 1, dtype=torch.bool), torch.ones(B)):
        with pytest.raises(ValueError):
            model.decode_step(params, model.init_cache(B, MAX_LEN), toks[:, 0],
                              token_mask=bad)


def test_prefill_matches_reference(setup):
    """The plain path's ragged prefill logits against the JAX reference's
    on the same weights and tokens."""
    cfg, ref_params, params = setup
    toks, mask = _tokens(3, len(LENS), cfg.vocab_size, LENS)
    ref = ref_build(cfg)
    want, _ = ref.prefill(ref_params, ref.init_cache(len(LENS), MAX_LEN, kind="paged"),
                          tokens=jnp.asarray(toks.numpy().astype(np.int32)),
                          pad_mask=jnp.asarray(mask.numpy()))
    model = _model()
    got, _ = model.prefill(params, model.init_cache(len(LENS), MAX_LEN), toks,
                           pad_mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)


def test_quantize_kv_rows_do_not_depend_on_the_row_count():
    """int8 KV codes and scales are per (row, head): a prompt's rows
    quantize as each token's row alone does."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((2, 10, 2, 16)).astype(np.float32))
    q, s = kv_cache.quantize_kv(t)
    for i in range(t.shape[1]):
        qi, si = kv_cache.quantize_kv(t[:, i:i + 1])
        assert torch.equal(qi, q[:, i:i + 1]) and torch.equal(si, s[:, i:i + 1])
