"""The port's training path against the reference on the CPU: loss and
every gradient leaf, one AdamW step (with and without microbatches and
int8 error-feedback compression), the LR schedules, the data pipeline,
the config schema and the training CLI.  Reduced minicpm-2b (MHA, tied
embeddings) and reduced qwen2.5-3b (GQA, qkv biases, untied head), f32
compute, weights bridged from the reference's param tree.

Tolerances: the two frameworks compute the same float32 math in other
summation orders; losses agree to ~1e-6 and every gradient leaf to
~1.3e-6 of its largest element here, so GRAD_RTOL = 1e-5 (of each
leaf's largest element) leaves a margin of ~8x and nothing more.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import get_config, reduced_config  # noqa: E402
from repro.data.pipeline import FileSource as RefFileSource  # noqa: E402
from repro.data.pipeline import SyntheticSource as RefSynthetic  # noqa: E402
from repro.data.pipeline import TokenStream as RefTokenStream  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.models.transformer import loss_fn as ref_loss_fn  # noqa: E402
from repro.optim.schedule import lr_at as ref_lr_at  # noqa: E402
from repro.runtime.train_loop import init_opt_state as ref_init_opt  # noqa: E402
from repro.runtime.train_loop import make_train_step as ref_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.data.pipeline import FileSource, SyntheticSource, TokenStream  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import Model, loss_fn  # noqa: E402
from repro_torch.optim.schedule import lr_at  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

ARCHS = ("minicpm-2b", "qwen2.5-3b")
ROWS, SEQ = 2, 24
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Reference model, params (numpy), batch, and the reference's loss and
    gradients of that batch."""
    cfg = reduced_config(get_config(request.param))
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = RefSynthetic(cfg.vocab_size, seed=3).batch(0, 0, ROWS, SEQ)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(model, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(params)
    return dict(name=request.param, model=model, params=params,
                np_params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def _port(a, **kw):
    pcfg = port_reduced(port_get_config(a["name"]))
    model = Model(pcfg, device="cpu", **kw)
    params = bridge.params_from_numpy(a["np_params"], device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in a["batch"].items()}
    return model, params, batch


def _port_loss_and_grads(a, remat="none"):
    model, params, batch = _port(a)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, aux = loss_fn(model, params, batch, remat=remat)
    loss.backward()
    return loss, aux, map_tree(lambda p: p.grad, params)


def _assert_tree_close(got, want, rtol, what):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        scale = np.abs(w).max() + 1e-30
        err = np.abs(g - w).max() / scale
        assert err <= rtol, f"{what} {jax.tree_util.keystr(path)}: {err:.3e} > {rtol}"


def test_loss_and_every_gradient_leaf_match_reference(arch):
    loss, aux, grads = _port_loss_and_grads(arch)
    assert abs(float(loss.detach()) - arch["loss"]) <= 1e-5 * abs(arch["loss"])
    assert float(aux["aux_loss"]) == 0.0
    got = bridge.params_to_numpy(grads, like=arch["np_params"])
    assert jax.tree.structure(got) == jax.tree.structure(arch["grads"])
    _assert_tree_close(got, arch["grads"], GRAD_RTOL, "grad")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat(arch, remat):
    """Recomputation repeats the same CPU ops: loss and grads bit-equal."""
    loss0, _, g0 = _port_loss_and_grads(arch, "none")
    loss1, _, g1 = _port_loss_and_grads(arch, remat)
    assert torch.equal(loss0, loss1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


# (microbatch, grad_compression)
STEP_CASES = [(0, "none"), (1, "none"), (1, "int8_ef")]


@pytest.mark.parametrize("microbatch,compression", STEP_CASES)
def test_train_step_matches_reference(arch, microbatch, compression):
    """One AdamW step from the same weights and batch: params, moments,
    loss, grad-norm and lr against the reference's.

    Each weight is held to rtol 1e-6 / atol 1e-7 plus what its own
    conditioning lets the gradients' agreement (GRAD_RTOL of the leaf's
    largest gradient, dg) move it (m, v: 1e-5 of the leaf's largest):
    * without compression, Adam's first step moves a weight by
      lr * g / (|g| + eps), whose slope in g is at most
      eps / (|g| - dg + eps)^2: a weight may differ by lr times dg times
      that slope (at most 2 lr, a flipped direction);
    * with int8 compression, a gradient within 127 dg / gmax of a
      rounding boundary of its code (|g| / scale = k + 0.5) may round
      either way: its moments may differ by one code step and its weight
      by 2 lr.  Fewer than 1% of the weights are such."""
    ocfg_kw = dict(schedule="wsd", warmup_steps=0)   # lr at step 1: the peak
    model, params, batch = _port(arch)
    tcfg = port_base.TrainConfig(microbatch=microbatch, grad_compression=compression)
    opt = init_opt_state(tcfg, params)
    new_p, new_opt, m = make_train_step(model, port_base.OptimConfig(**ocfg_kw), tcfg)(
        params, opt, batch)

    rtcfg = ref_base.TrainConfig(microbatch=microbatch, grad_compression=compression)
    ref_step = jax.jit(ref_make_step(arch["model"], ref_base.OptimConfig(**ocfg_kw), rtcfg))
    rp, ropt, rm = ref_step(arch["params"], ref_init_opt(rtcfg, arch["params"]),
                            jax.tree.map(jnp.asarray, arch["batch"]))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"]))
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= 1e-5 * float(rm["grad_norm"])
    assert np.float32(m["lr"]) == np.asarray(rm["lr"])
    assert new_opt["adam"]["step"] == int(ropt["adam"]["step"]) == 1
    lr, eps = m["lr"], ref_base.OptimConfig().eps

    like = arch["np_params"]
    got = {k: jax.tree.leaves(bridge.params_to_numpy(t, like=like)) for k, t in
           (("p", new_p), ("m", new_opt["adam"]["m"]), ("v", new_opt["adam"]["v"]))}
    want = {k: [np.asarray(x) for x in jax.tree.leaves(t)] for k, t in
            (("p", rp), ("m", ropt["adam"]["m"]), ("v", ropt["adam"]["v"]))}
    n_boundary = 0
    for i, g in enumerate(jax.tree.leaves(arch["grads"])):
        gmax = np.abs(g).max()
        dg = GRAD_RTOL * gmax
        if compression == "int8_ef":
            code = gmax / 127.0 / max(float(rm["grad_norm"]), 1.0)   # one clipped code
            x = np.abs(g) / (gmax / 127.0)
            boundary = np.abs(x - np.floor(x) - 0.5) < 127.0 * GRAD_RTOL
            n_boundary += int(boundary.sum())
            extra = {"p": np.where(boundary, 2 * lr, 0.0),
                     "m": np.where(boundary, 0.1 * code * 1.01, 0.0),
                     "v": np.where(boundary, 0.05 * 256 * code * code * 1.01, 0.0)}
        else:
            slope = eps / (np.maximum(np.abs(g) - dg, 0.0) + eps) ** 2
            extra = {"p": lr * np.minimum(2.0, dg * slope), "m": 0.0, "v": 0.0}
        for k in ("p", "m", "v"):
            a, w = got[k][i], want[k][i]
            tol = (1e-7 + 1e-6 * np.abs(w) if k == "p"
                   else 1e-5 * (np.abs(w).max() + 1e-30)) + extra[k]
            bad = np.abs(a - w) > tol
            assert not bad.any(), (k, i, np.abs(a - w)[bad], g[bad])
    assert n_boundary < 1e-2 * sum(g.size for g in jax.tree.leaves(arch["grads"]))


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "linear"])
def test_lr_schedules_match_reference(schedule):
    kw = dict(schedule=schedule, warmup_steps=100, total_steps=1000, wsd_decay_frac=0.1)
    rc, pc = ref_base.OptimConfig(**kw), port_base.OptimConfig(**kw)
    for step in (0, 1, 50, 100, 101, 500, 899, 900, 901, 950, 999, 1000, 1500):
        np.testing.assert_allclose(lr_at(pc, step), float(ref_lr_at(rc, step)), rtol=1e-6)
    no_warm = dataclasses.replace(pc, warmup_steps=0)
    np.testing.assert_allclose(lr_at(no_warm, 0), float(ref_lr_at(
        dataclasses.replace(rc, warmup_steps=0), 0)), rtol=1e-6)


def test_token_batches_are_the_reference_bits(tmp_path):
    for seed, step, host in ((1234, 0, 0), (1234, 7, 3), (5, 2, 1)):
        np.testing.assert_array_equal(SyntheticSource(122753, seed).batch(step, host, 2, 64),
                                      RefSynthetic(122753, seed).batch(step, host, 2, 64))
    ours = TokenStream(SyntheticSource(300, seed=1234), global_batch=4, seq_len=16,
                       num_hosts=2, host_index=1, start_step=2)
    ref = RefTokenStream(RefSynthetic(300, seed=1234), global_batch=4, seq_len=16,
                         num_hosts=2, host_index=1, start_step=2)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    path = tmp_path / "toks.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    np.testing.assert_array_equal(FileSource(str(path), 600).batch(3, 1, 2, 32),
                                  RefFileSource(str(path), 600).batch(3, 1, 2, 32))


def test_cross_entropies_match_reference():
    """Padded vocab columns masked and negative labels ignored: the plain
    and the chunked (fused) CE against the reference's, f32."""
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(port_reduced(port_get_config("qwen2.5-3b")), vocab_size=250)
    rcfg = dataclasses.replace(reduced_config(get_config("qwen2.5-3b")), vocab_size=250)
    logits = rng.standard_normal((2, 9, cfg.padded_vocab)).astype(np.float32)
    labels = rng.integers(-1, 250, (2, 9)).astype(np.int32)
    want = float(ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 250))
    got = float(L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 250))
    assert abs(got - want) <= 1e-6 * abs(want)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    head = {"kernel": rng.standard_normal((cfg.d_model, cfg.padded_vocab)).astype(np.float32)
            * 0.1}
    emb = {"embedding": np.zeros((cfg.padded_vocab, cfg.d_model), np.float32)}
    want = float(ref_layers.fused_cross_entropy(
        rcfg, jax.tree.map(jnp.asarray, head), jax.tree.map(jnp.asarray, emb),
        jnp.asarray(x), jnp.asarray(labels), chunk=4))
    got = float(L.fused_cross_entropy(
        cfg, map_tree(torch.from_numpy, head), map_tree(torch.from_numpy, emb),
        torch.from_numpy(x), torch.from_numpy(labels), chunk=4))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_config_dataclasses_have_the_reference_fields_and_defaults():
    names = [n for n, c in vars(ref_base).items()
             if dataclasses.is_dataclass(c) and isinstance(c, type)]
    assert {"ModelConfig", "TrainConfig", "OptimConfig", "RunConfig"} <= set(names)

    def default(f):
        if f.default is not dataclasses.MISSING:
            return repr(f.default)
        if f.default_factory is not dataclasses.MISSING:
            return repr(f.default_factory())
        return "required"

    for n in names:
        ref = [(f.name, default(f)) for f in dataclasses.fields(getattr(ref_base, n))]
        port = [(f.name, default(f)) for f in dataclasses.fields(getattr(port_base, n))]
        assert [(k, v.replace("repro.", "")) for k, v in ref] == \
            [(k, v.replace("repro_torch.", "")) for k, v in port], n


def test_train_cli_runs_on_cpu_and_needs_a_card_by_default(capsys):
    records = port_train.main(["--arch", "minicpm-2b", "--smoke", "--steps", "3",
                               "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)
    assert out.count("loss") == 3 and "tok/s" in out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_train.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                         "--mesh", "2x2"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_train.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                         "--ckpt", "ck"])
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])
