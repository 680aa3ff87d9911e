"""The port's SSM (Mamba-2) training path against the reference on the
CPU: reduced mamba2-370m (2 layers, d_model 64, 8 SSD heads of P = 16,
N = 16), seq 256 (two chunks of 128, so the chunk algorithm and the
explicit backward run), batch 2, weights bridged from the reference's
param tree: the mixer layer, the loss and every gradient leaf, one AdamW
step, remat, the training CLI and the serving refusals.

Tolerances: f32 throughout, the same math in other summation orders.
The mixer output agrees to ~1e-6 of its largest element (FWD_RTOL =
2e-5); the loss to ~1e-7 relative (1e-5); every gradient leaf to ~7e-6
of its largest element here (a_log and dt_bias sum over every position:
GRAD_RTOL = 5e-5).  The AdamW step's tolerance is argued in
``test_train_step_matches_reference``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import get_config, reduced_config  # noqa: E402
from repro.data.pipeline import SyntheticSource as RefSynthetic  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.models.transformer import loss_fn as ref_loss_fn  # noqa: E402
from repro.runtime.train_loop import init_opt_state as ref_init_opt  # noqa: E402
from repro.runtime.train_loop import make_train_step as ref_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_loss, make_train_step  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

ARCH = "mamba2-370m"
ROWS, SEQ = 2, 256
FWD_RTOL = 2e-5
GRAD_RTOL = 5e-5


@pytest.fixture(scope="module")
def ref():
    """Reference model, params (numpy), batch, and the reference's loss and
    gradients of that batch after the train step's compute-dtype cast."""
    cfg = reduced_config(get_config(ARCH))
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = RefSynthetic(cfg.vocab_size, seed=3).batch(0, 0, ROWS, SEQ)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cdt = jnp.dtype(cfg.compute_dtype)

    def loss_of(p):
        pc = jax.tree.map(lambda a: a.astype(cdt)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a, p)
        return ref_loss_fn(model, pc, jax.tree.map(jnp.asarray, batch))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return dict(cfg=cfg, model=model, params=params,
                np_params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def _port(r, **kw):
    model = Model(port_reduced(port_get_config(ARCH)), device="cpu", **kw)
    params = bridge.params_from_numpy(r["np_params"], device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in r["batch"].items()}
    return model, params, batch


def _loss_and_grads(r, remat="none"):
    model, params, batch = _port(r)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = make_loss(model, remat)(params, batch)
    loss.backward()
    return loss, map_tree(lambda p: p.grad, params)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def test_ssm_apply_matches_reference(ref):
    cfg = ref["cfg"]
    layer = jax.tree.map(lambda a: a[0], ref["params"]["groups"][0]["mixer"])
    x = np.random.default_rng(0).normal(size=(ROWS, SEQ, cfg.d_model)).astype(np.float32)
    want = ref_ssm.apply(cfg, layer, jnp.asarray(x))
    port_layer = bridge.params_from_numpy(ref["np_params"], "cpu")["layers"][0]["mixer"]
    got = ssm.apply(port_reduced(port_get_config(ARCH)), port_layer, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= FWD_RTOL


def test_ssm_leaves_cross_the_bridge_bit_for_bit(ref):
    state = bridge.params_from_numpy(ref["np_params"], "cpu")
    mixer = state["layers"][1]["mixer"]
    assert set(mixer) == {"in_proj", "conv", "conv_bias", "a_log", "dt_bias", "d_skip",
                          "gate_norm", "out_proj"}
    back = bridge.params_to_numpy(state, like=ref["np_params"])
    for w, g in zip(jax.tree.leaves(ref["np_params"]), jax.tree.leaves(back)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_init_makes_the_reference_tree():
    """The port's init draws other random numbers (torch.Generator) into
    the reference's tree: same leaves, shapes and dtypes, the same
    deterministic leaves, dt_bias the inverse softplus of a dt in
    [dt_min, dt_max]."""
    cfg = reduced_config(get_config(ARCH))
    want = jax.tree.map(np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))
    model = Model(port_reduced(port_get_config(ARCH)), device="cpu")
    got = bridge.params_to_numpy(model.init(torch.Generator().manual_seed(0)), like=want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert g.shape == w.shape and g.dtype == w.dtype
    gm, wm = got["groups"][0]["mixer"], want["groups"][0]["mixer"]
    for k in ("conv_bias", "d_skip"):
        np.testing.assert_array_equal(gm[k], wm[k])
    # log(1..H): torch's and XLA's float32 log may differ in the last bit
    np.testing.assert_allclose(gm["a_log"], wm["a_log"], rtol=2.5e-7, atol=0)
    dt = np.log1p(np.exp(gm["dt_bias"]))
    assert (dt >= cfg.ssm.dt_min * 0.999).all() and (dt <= cfg.ssm.dt_max * 1.001).all()


def test_loss_and_every_gradient_leaf_match_reference(ref):
    loss, grads = _loss_and_grads(ref)
    assert abs(float(loss.detach()) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    got = bridge.params_to_numpy(grads, like=ref["np_params"])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref["grads"]),
                            jax.tree.leaves(got)):
        err = _rel(g, w)
        assert err <= GRAD_RTOL, f"grad {jax.tree_util.keystr(path)}: {err:.3e}"


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat(ref, remat):
    """Recomputation repeats the same CPU ops: loss and grads bit-equal,
    except the embedding's gradient, whose CPU backward (an accumulating
    index_put over 512 tokens of a 256-word vocab) adds repeated tokens
    in a thread-dependent order and differs in the last bits from run to
    run even without remat: held to 1e-6 of its largest element."""
    loss0, g0 = _loss_and_grads(ref, "none")
    loss1, g1 = _loss_and_grads(ref, remat)
    assert torch.equal(loss0, loss1)
    emb = g0["embed"]["embedding"]
    assert _rel(g1["embed"]["embedding"], emb) <= 1e-6
    del g0["embed"], g1["embed"]
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


def test_remat_dots_keeps_only_the_projection_products(ref, monkeypatch):
    """Under remat "dots" the saved ops of each SSM layer are its two 2-D
    projection products (in_proj, out_proj); the scan is recomputed."""
    saved = []
    real = transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if policy == transformer.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append(op)
        return policy

    monkeypatch.setattr(transformer, "_save_dots", spy)
    _loss_and_grads(ref, "dots")
    cfg = ref["cfg"]
    assert len(saved) == 2 * cfg.num_layers
    assert set(saved) <= set(transformer._DOTS)


def test_train_step_matches_reference(ref):
    """One AdamW step from the same weights and batch.  Adam's first step
    moves a weight by lr g / (|g| + eps); with the gradients agreeing to
    GRAD_RTOL of each leaf's largest, dg, a weight may differ by lr dg
    eps / (|g| - dg + eps)^2 (at most 2 lr, a flipped direction); the
    moments to 1e-4 of the leaf's largest."""
    ocfg_kw = dict(warmup_steps=0)
    model, params, batch = _port(ref)
    tcfg = port_base.TrainConfig(microbatch=1)
    new_p, new_opt, m = make_train_step(model, port_base.OptimConfig(**ocfg_kw), tcfg)(
        params, init_opt_state(tcfg, params), batch)
    rtcfg = ref_base.TrainConfig(microbatch=1)
    rp, ropt, rm = jax.jit(ref_make_step(ref["model"], ref_base.OptimConfig(**ocfg_kw),
                                         rtcfg))(
        ref["params"], ref_init_opt(rtcfg, ref["params"]),
        jax.tree.map(jnp.asarray, ref["batch"]))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"]))
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= 1e-5 * float(rm["grad_norm"])
    lr, eps = m["lr"], ref_base.OptimConfig().eps
    like = ref["np_params"]
    got = {k: jax.tree.leaves(bridge.params_to_numpy(t, like=like)) for k, t in
           (("p", new_p), ("m", new_opt["adam"]["m"]), ("v", new_opt["adam"]["v"]))}
    want = {k: [np.asarray(x) for x in jax.tree.leaves(t)] for k, t in
            (("p", rp), ("m", ropt["adam"]["m"]), ("v", ropt["adam"]["v"]))}
    for i, g in enumerate(jax.tree.leaves(ref["grads"])):
        dg = GRAD_RTOL * np.abs(g).max()
        slope = eps / (np.maximum(np.abs(g) - dg, 0.0) + eps) ** 2
        for k in ("p", "m", "v"):
            a, w = got[k][i], want[k][i]
            tol = (1e-7 + 1e-6 * np.abs(w) + lr * np.minimum(2.0, dg * slope) if k == "p"
                   else 1e-4 * (np.abs(w).max() + 1e-30))
            bad = np.abs(a - w) > tol
            assert not bad.any(), (k, i, np.abs(a - w)[bad])


def test_train_cli_runs_on_cpu(capsys):
    records = port_train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--device", "cpu",
                               "--log-every", "1"])
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)
    assert "arch=mamba2-370m-smoke" in capsys.readouterr().out


def test_serving_entry_points_raise_for_ssm_models(ref):
    """SSM serving is ported: the entry points that raised serve.
    init_cache gives an SSMCache a layer; prefill, decode_step and the
    cache-writing apply run, the prefill's last logits equal the
    cache-writing apply's and its decode step's logits are finite; only a
    read-only peek raises (an SSM layer must write its state through)."""
    model, params, batch = _port(ref)
    toks = batch["tokens"][:, :8]
    cache = model.init_cache(2, 16)
    assert all(isinstance(c, transformer.ssm.SSMCache) for c in cache["layers"])
    logits, cache = model.prefill(params, cache, toks)
    assert logits.shape == (2, model.cfg.padded_vocab)
    step, cache = model.decode_step(params, cache, toks[:, 0])
    assert cache["pos"] == 9 and torch.isfinite(step).all()
    out = model.apply(params, toks, cache=model.init_cache(2, 16), write_cache=True,
                      last_only=True)
    assert torch.equal(out["logits"][:, 0], logits)
    with pytest.raises(ValueError, match="peek"):
        model.apply(params, toks, cache=model.init_cache(2, 16), write_cache=True,
                    peek=True)
    one = ssm.init_cache(model.cfg, 2, torch.float32)
    y, one = ssm.decode_step(model.cfg, params["layers"][0]["mixer"],
                             torch.zeros((2, 1, model.cfg.d_model)), one)
    assert y.shape == (2, 1, model.cfg.d_model)
