"""The port's model against the reference on the qwen2.5-3b smoke config:
ragged batched prefill, then paged decode steps, float and EN-T
quantized, weights bridged from the reference's param tree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.models.transformer import Model, build_model  # noqa: E402

B, S0, STEPS, MAX_LEN = 3, 12, 4, 32
LENS = np.asarray([12, 7, 3])
# float: the same f32 math in another summation order (see the
# attention tests), amplified by two layers and the LM head
FLOAT_TOL = 1e-4
# quantized: a ~1e-7 float difference ahead of a projection can move an
# activation across a rounding boundary, flipping its int8 code by one
# step; one flip shifts that projection's output by sx*sw*|W| (~1e-3
# here), and the logits by about that
QUANT_TOL = 5e-3


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S0)).astype(np.int32)
    mask = np.arange(S0)[None, :] >= (S0 - LENS[:, None])
    toks = np.where(mask, toks, 0)
    steps = rng.integers(1, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return cfg, params, toks, mask, steps


def _ref_run(cfg, params, toks, mask, steps):
    model = ref_build(cfg)
    cache = model.init_cache(B, MAX_LEN, kind="paged")
    logits, cache = model.prefill(params, cache, tokens=jnp.asarray(toks),
                                  pad_mask=jnp.asarray(mask))
    outs = [np.asarray(logits)]
    for t in steps:
        logits, cache = model.decode_step(params, cache, tokens=jnp.asarray(t))
        outs.append(np.asarray(logits))
    return np.stack(outs)


def _port_run(params, toks, mask, steps, kind="paged"):
    model = Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu")
    cache = model.init_cache(B, MAX_LEN, kind=kind)
    logits, cache = model.prefill(params, cache, torch.from_numpy(toks).long(),
                                  pad_mask=torch.from_numpy(mask))
    outs = [logits.numpy()]
    for t in steps:
        logits, cache = model.decode_step(params, cache, torch.from_numpy(t).long())
        outs.append(logits.numpy())
    return np.stack(outs)


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_and_decode_logits_match_reference(setup, quantized):
    cfg, params, toks, mask, steps = setup
    if quantized:
        params = ref_quantize(params, QuantConfig(enabled=True))
    want = _ref_run(cfg, params, toks, mask, steps)
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = _port_run(port_params, toks, mask, steps)
    tol = QUANT_TOL if quantized else FLOAT_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_paged_decode_equals_dense_decode(setup):
    _, params, toks, mask, steps = setup
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    paged = _port_run(port_params, toks, mask, steps, kind="paged")
    dense = _port_run(port_params, toks, mask, steps, kind="dense")
    np.testing.assert_array_equal(paged, dense)


def test_model_init_quantizes_layer_by_layer():
    cfg = port_reduced(port_get_config("qwen2.5-3b"))
    from repro_torch.configs.base import QuantConfig as PortQuantConfig
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, quant=PortQuantConfig(enabled=True))
    layer = params["layers"][0]
    assert set(layer["mixer"]["wq"]) == {"q", "scale", "planes_packed", "bias"}
    assert layer["mixer"]["wq"]["planes_packed"].shape == (2, cfg.d_model,
                                                          cfg.num_heads * cfg.head_dim)
    assert "kernel" in params["lm_head"]          # skip patterns hold
    cache = model.init_cache(2, 16)
    logits, _ = model.prefill(params, cache, torch.ones((2, 8), dtype=torch.long))
    assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits).all()


def test_unported_layer_specs_raise():
    """Every layer spec of the reference's configs is ported: SSM and MoE
    models build (mamba2-370m, mixtral-8x7b, the hybrid jamba-1.5-large)
    and run a forward with their auxiliary loss; a spec outside (mixer
    attn / ssm, FFN dense / moe / none) still raises."""
    import dataclasses
    for arch in ("mamba2-370m", "mixtral-8x7b", "jamba-1.5-large"):
        cfg = port_reduced(port_get_config(arch))
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        out = model.apply(params, torch.ones((1, 6), dtype=torch.long))
        assert out["logits"].shape == (1, 6, cfg.padded_vocab)
        assert (float(out["aux_loss"]) > 0) == (cfg.moe is not None)
    bad = dataclasses.replace(port_reduced(port_get_config("qwen2.5-3b")),
                              group=(("attn", "conv"),))
    with pytest.raises(NotImplementedError):
        Model(bad, device="cpu")


def test_paged_cache_slot_management_moves_indices_only():
    from repro_torch.models import kv_cache
    cache = kv_cache.paged_init(3, 8, 2, 16, torch.float32, page_size=4,
                                pages=6, mapped=False)
    table = torch.tensor([[1, 2], [3, 0], [0, 0]], dtype=torch.int32)
    assert cache.with_table(table) is cache and cache.block_table is table
    view = cache.prefill_view(1)
    assert view.k is cache.k and view.v is cache.v       # the pools are shared
    kv = torch.ones((1, 3, 2, 16))
    view.write_prompt(kv, 2 * kv, 0)                     # through slot 1's page
    assert cache.admit(view, 1) is cache
    assert torch.equal(cache.k[3, :3], kv[0]) and not cache.k[3, 3].any()
    assert not cache.k[[0, 1, 2, 4, 5, 6]].any()
    cache.free_slot(0)
    assert table[0].tolist() == [0, 0] and table[1].tolist() == [3, 0]
