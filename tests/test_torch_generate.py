"""The one-shot ``generate`` path and ``embeds`` inputs, the port against
the reference.

* ``generate`` on the reduced qwen2.5-3b (float32, the reference's
  weights through numpy): greedy streams equal to the reference's for
  ragged left-padded ``prompt_lens``, EOS early stop padded back to
  ``[B, steps]``, ``prefill`` batched and sequential (bit for bit equal
  to each other on the port's plain path), every ``cache_kind`` (dense,
  paged; the ring at reduced starcoder2-15b) and ``prefill_chunk``.
* Temperature 0.9: the truncated distributions (``_truncate``) equal the
  reference's exactly on the reference's own prefill logits, every
  sampled first token lies in the port's truncated support, and the
  port's streams replay for a seed and move with it.
* ``make_prefill_step`` / ``make_serve_step`` against the reference's.
* ``embeds`` through ``apply``, ``prefill`` and ``decode_step`` at
  reduced musicgen-medium and llava-next-34b, within the 1e-4 of
  ``tests/test_torch_model.py`` (f32 in another order).
* The CLI without ``--engine`` (``--smoke --device cpu``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.runtime import sampling as ref_sampling  # noqa: E402
from repro.runtime import serve_loop as ref_loop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402

FLOAT_TOL = 1e-4   # as tests/test_torch_model.py
LENS = [12, 7, 3]
S0, STEPS = 12, 8


@functools.lru_cache(maxsize=None)
def _setup(arch="qwen2.5-3b"):
    cfg = reduced_config(get_config(arch))
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(2))
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, ref, params, Model(port_reduced(port_get_config(arch)), device="cpu"), \
        port_params


def _prompts(seed=0, lens=LENS):
    toks = np.random.default_rng(seed).integers(1, 256, (len(lens), S0))
    return np.where(np.arange(S0)[None, :] >= S0 - np.asarray(lens)[:, None], toks, 0)


@functools.lru_cache(maxsize=None)
def _ref_generate(arch, **kw):
    cfg, ref, params, _, _ = _setup(arch)
    kw = dict(kw)
    lens = kw.pop("lens", None)
    toks = jnp.asarray(_prompts(lens=lens or LENS))
    return np.asarray(ref_loop.generate(ref, params, toks, STEPS, prompt_lens=lens, **kw))


@pytest.mark.parametrize("kw", [
    dict(lens=tuple(LENS)),
    dict(lens=tuple(LENS), prefill="sequential"),
    dict(lens=tuple(LENS), cache_kind="paged"),
    dict(lens=tuple(LENS), cache_kind="dense", prefill_chunk=5),
    dict(lens=None, prefill_chunk=4),
], ids=["ragged", "sequential", "paged", "dense-chunk5", "uniform-chunk4"])
def test_greedy_streams_equal_reference(kw):
    _, _, _, model, params = _setup()
    got = serve_loop.generate(model, params, _prompts(lens=kw.get("lens") or LENS), STEPS,
                              prompt_lens=kw.get("lens"),
                              **{k: v for k, v in kw.items() if k != "lens"})
    assert got.dtype == torch.int32 and got.shape == (3, STEPS)
    np.testing.assert_array_equal(got.numpy(), _ref_generate("qwen2.5-3b", **kw))


def test_ring_generate_equals_reference():
    """A sliding-window model's default cache is the ring; prompts of 12
    over a window of 8 wrap in the prefill."""
    _, _, _, model, params = _setup("starcoder2-15b")
    got = serve_loop.generate(model, params, _prompts(), STEPS, prompt_lens=LENS,
                              prefill_chunk=5)
    want = _ref_generate("starcoder2-15b", lens=tuple(LENS), prefill_chunk=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_prefill_equals_sequential_bitwise():
    _, _, _, model, params = _setup()
    kw = dict(prompt_lens=LENS, temperature=0.9, top_k=20, seed=3)
    batched = serve_loop.generate(model, params, _prompts(), STEPS, **kw)
    seq = serve_loop.generate(model, params, _prompts(), STEPS, prefill="sequential", **kw)
    assert torch.equal(batched, seq)


def test_eos_early_stop_pads_to_steps():
    """Each row's third greedy token is its EOS in turn: the row emits it,
    then pads; the reference gives the same [B, steps]."""
    _, _, _, model, params = _setup()
    free = serve_loop.generate(model, params, _prompts(), STEPS, prompt_lens=LENS).numpy()
    eos = int(free[0, 2])
    got = serve_loop.generate(model, params, _prompts(), STEPS, prompt_lens=LENS,
                              eos_id=eos, pad_id=0).numpy()
    want = _ref_generate("qwen2.5-3b", lens=tuple(LENS), eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got, want)
    first = list(free[0]).index(eos)
    assert list(got[0, :first + 1]) == list(free[0, :first + 1])
    assert not got[0, first + 1:].any()
    # every row done at once: the loop stops early and still returns [B, steps]
    one = serve_loop.generate(model, params, _prompts()[:1], STEPS, prompt_lens=LENS[:1],
                              eos_id=int(free[0, 0]))
    assert one.shape == (1, STEPS) and one[0, 0] == free[0, 0] and not one[0, 1:].any()


def test_temperature_truncation_and_replay():
    cfg, ref, rparams, model, params = _setup()
    toks = _prompts()
    rcache = ref.init_cache(3, S0 + STEPS)
    mask, start = ref_loop._pad_mask_from_lens(LENS, 3, S0)
    rcache["start"] = start
    rlogits = np.asarray(ref.prefill(rparams, rcache, tokens=jnp.asarray(toks),
                                     pad_mask=mask)[0]) / 0.9
    for top_k, top_p in ((20, None), (None, 0.9), (20, 0.9)):
        want = np.asarray(ref_sampling._truncate(jnp.asarray(rlogits), top_k, top_p))
        got = sampling._truncate(torch.from_numpy(rlogits), top_k, top_p).numpy()
        np.testing.assert_array_equal(got, want)
    kw = dict(prompt_lens=LENS, temperature=0.9, top_k=20, top_p=0.9)
    a = serve_loop.generate(model, params, toks, STEPS, seed=7, **kw)
    assert torch.equal(a, serve_loop.generate(model, params, toks, STEPS, seed=7, **kw))
    assert not torch.equal(a, serve_loop.generate(model, params, toks, STEPS, seed=8, **kw))
    pmask, pstart = serve_loop._pad_mask_from_lens(LENS, 3, S0)
    cache = model.init_cache(3, S0 + STEPS, kind="dense")
    cache["start"] = pstart
    plog = model.prefill(params, cache, torch.from_numpy(toks), pad_mask=pmask)[0]
    support = sampling._truncate(plog / 0.9, 20, 0.9) > -1e29
    assert bool(support[torch.arange(3), a[:, 0].long()].all())


def test_steps_match_reference_steps():
    cfg, ref, rparams, model, params = _setup()
    toks = _prompts(lens=[S0] * 3)
    want = np.asarray(ref_loop.make_prefill_step(ref)(rparams, {"tokens": jnp.asarray(toks)}))
    got = serve_loop.make_prefill_step(model)(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_TOL)
    rstep, step = ref_loop.make_serve_step(ref), serve_loop.make_serve_step(model)
    rcache, cache = ref.init_cache(3, 16), model.init_cache(3, 16, kind="dense")
    for t in range(4):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, t]))
        pl, cache = step(params, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0, atol=FLOAT_TOL)


def test_bad_arguments_raise():
    _, _, _, model, params = _setup()
    for args, kw in (((np.zeros((2, 0), np.int64), 4), {}), ((_prompts(), 0), {}),
                     ((_prompts(), 4), dict(prefill="bogus")),
                     ((_prompts(), 4), dict(prompt_lens=[3, 4])),
                     ((_prompts(), 4), dict(prompt_lens=[13, 4, 2]))):
        with pytest.raises(ValueError):
            serve_loop.generate(model, params, *args, **kw)


# .. embeds ..

@pytest.mark.parametrize("arch", ["musicgen-medium", "llava-next-34b"])
def test_embeds_paths_equal_reference(arch):
    """Frame / patch embeddings in place of tokens: the full forward, the
    cache-writing prefill (one shot and chunked) and decode steps fed
    embeddings, each within 1e-4 of the reference."""
    cfg, ref, rparams, model, params = _setup(arch)
    emb = np.random.default_rng(5).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref.apply(rparams, embeds=jnp.asarray(emb))["logits"])
    got = model.apply(params, embeds=torch.from_numpy(emb))["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_TOL)
    for chunk in (None, 4):
        rl, rcache = ref.prefill(rparams, ref.init_cache(2, 16), embeds=jnp.asarray(emb[:, :6]),
                                 chunk=chunk)
        pl, cache = model.prefill(params, model.init_cache(2, 16, kind="dense"),
                                  embeds=torch.from_numpy(emb[:, :6]), chunk=chunk)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0, atol=FLOAT_TOL)
        for t in range(6, 9):
            rl, rcache = ref.decode_step(rparams, rcache, embeds=jnp.asarray(emb[:, t:t + 1]))
            pl, cache = model.decode_step(params, cache, embeds=torch.from_numpy(emb[:, t:t + 1]))
            np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0, atol=FLOAT_TOL)


# .. the CLI ..

@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "auto"), ("qwen2.5-3b", "paged"),
                                       ("starcoder2-15b", "auto")])
def test_launch_serve_generate_cpu(capsys, arch, kind):
    out = port_serve.main(["--arch", arch, "--smoke", "--quantize", "--device", "cpu",
                           "--batch", "2", "--steps", "4", "--prompt-len", "12",
                           "--cache-kind", kind, "--prefill-chunk", "5"])
    text = capsys.readouterr().out
    assert "generated 2x4 tokens" in text and out.shape == (2, 4)
