"""MoE layers in the port against the reference on the CPU: ``moe.apply``
(y and the Switch auxiliary loss) on reduced mixtral-8x7b, dbrx-132b
(with its top-4 routing over 8 experts) and jamba-1.5-large, in a batch
that overflows the experts' capacity and in one that does not; the
quantization walk (experts and router stay float); a reduced mixtral's
training loss (auxiliary loss included) and every gradient leaf; and the
engine's greedy streams against the reference engine's, mixtral through
the ring (window 8) and dbrx paged.

Tolerances: both packages compute the same float32 sums in other orders
(the expert products are ``einsum`` there and ``bmm`` here): y agrees to
~1e-6 of its largest element, so Y_RTOL = 1e-5; a different set of
dropped assignments moves whole rows (the planted fault "pairs in
k-major order" reads ~0.1-1).  The loss and gradients as
``tests/test_torch_train.py``: GRAD_RTOL = 1e-5 of each leaf's largest
element."""

import dataclasses
import functools
import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ref_proc as ref_proc  # noqa: E402
from repro.configs import QuantConfig as RefQuantConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.data.pipeline import SyntheticSource as RefSynthetic  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.models.transformer import loss_fn as ref_loss_fn  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import Model, loss_fn  # noqa: E402
from repro_torch.quant.quantize import quantize_params  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

Y_RTOL = 1e-5
GRAD_RTOL = 1e-5
# arch -> MoE overrides of the reduced config (dbrx keeps its top-4 over 8
# experts; the reduced config would cut it to top-2 of 4)
MOE_ARCHS = {"mixtral-8x7b": {}, "dbrx-132b": dict(num_experts=8, top_k=4),
             "jamba-1.5-large": {}}
# capacity factor -> whether the batch overflows: 0.5 drops, the reduced
# config's E / k never does
CAPACITY = {"overflow": 0.5, "dropless": None}


def _configs(arch, cf=None, **moe_kw):
    """(reference config, port config) with the MoE overrides."""
    pairs = []
    for cfg in (ref_reduced(ref_get_config(arch)), reduced_config(get_config(arch))):
        m = dataclasses.replace(cfg.moe, **moe_kw)
        if cf is not None:
            m = dataclasses.replace(m, capacity_factor=cf)
        pairs.append(dataclasses.replace(cfg, moe=m))
    return pairs


def _layer(arch, cf=None, **moe_kw):
    """Reference and port configs and one MoE layer's params (the
    reference's ``moe.init``, crossed to torch)."""
    rcfg, cfg = _configs(arch, cf, **{**MOE_ARCHS[arch], **moe_kw})
    rp = ref_moe.init(jax.random.PRNGKey(2), rcfg)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    return rcfg, rp, cfg, pp


def _x(cfg, b=3, s=7, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol=Y_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= rtol, err
    return err


def _reference_keep(cfg, idx):
    """The reference's dispatch in numpy: exclusive cumsum positions of the
    token-major (token, k) pairs, kept below the capacity."""
    flat = idx.reshape(-1)
    onehot = np.eye(cfg.moe.num_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    cap = max(int(cfg.moe.capacity_factor * idx.shape[0] * cfg.moe.top_k
                  / cfg.moe.num_experts + 0.5), 1)
    return pos < cap


@pytest.mark.parametrize("case", sorted(CAPACITY))
@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_apply_matches_reference(arch, case):
    """y and the auxiliary loss against the reference's ``moe.apply``; the
    port drops exactly the assignments the reference's dispatch drops
    (some in the overflowing batch, none in the other)."""
    rcfg, rp, cfg, pp = _layer(arch, CAPACITY[case])
    x = _x(cfg)
    y_ref, aux_ref = ref_moe.apply(rcfg, rp, jnp.asarray(x))
    y, aux = moe.apply(cfg, pp, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close(y, y_ref)
    assert abs(float(aux) - float(aux_ref)) <= 1e-6 * abs(float(aux_ref))
    _, _, idx = moe.route(cfg, pp, torch.from_numpy(x).reshape(-1, cfg.d_model))
    _, _, keep = moe.dispatch(cfg, idx)
    want = _reference_keep(cfg, idx.numpy())
    assert np.array_equal(keep.numpy(), want)
    assert (~want).any() == (case == "overflow")


def test_planted_fault_k_major_order_reads_over_the_limit(monkeypatch):
    """A dispatch that takes the pairs in k-major order (every token's first
    choice before any second choice) drops other assignments in the
    overflowing batch: y reads far over Y_RTOL."""
    rcfg, rp, cfg, pp = _layer("mixtral-8x7b", CAPACITY["overflow"])
    x = _x(cfg)
    y_ref, _ = ref_moe.apply(rcfg, rp, jnp.asarray(x))
    real = moe.dispatch

    def k_major(cfg_, idx):
        t, k = idx.shape
        flat, pos, keep = real(cfg_, idx.t().contiguous())
        back = lambda v: v.reshape(k, t).t().reshape(-1)   # noqa: E731
        return back(flat), back(pos), back(keep)

    monkeypatch.setattr(moe, "dispatch", k_major)
    y, _ = moe.apply(cfg, pp, torch.from_numpy(x))
    err = np.abs(y.numpy() - np.asarray(y_ref)).max() / np.abs(np.asarray(y_ref)).max()
    assert err > 100 * Y_RTOL


def test_decode_tick_capacity_drops_like_the_reference():
    """The card's decode tick shape on mixtral's MoE config (8 experts top-2,
    capacity factor 1.25): T = 8 tokens give a capacity of 3; over 8 ticks
    some assignments pass it, and the port drops the ones the reference's
    dispatch drops, with y equal to the reference's."""
    cfg = get_config("mixtral-8x7b")
    assert moe.capacity(cfg, 8) == 3
    rcfg, rp, pcfg, pp = _layer("mixtral-8x7b", 1.25, num_experts=8)
    assert moe.capacity(pcfg, 8) == 3
    rng = np.random.default_rng(5)
    dropped = 0
    for _ in range(8):
        x = rng.standard_normal((8, 1, pcfg.d_model)).astype(np.float32)
        y_ref, _ = ref_moe.apply(rcfg, rp, jnp.asarray(x))
        y, _ = moe.apply(pcfg, pp, torch.from_numpy(x))
        _close(y, y_ref)
        _, _, idx = moe.route(pcfg, pp, torch.from_numpy(x).reshape(8, -1))
        keep = moe.dispatch(pcfg, idx)[2].numpy()
        assert np.array_equal(keep, _reference_keep(pcfg, idx.numpy()))
        dropped += int((~keep).sum())
    assert dropped > 0


def test_bf16_combine_matches_reference():
    """In bf16 compute the gates weight the rows and a token's k rows sum in
    the compute dtype (slot order): within a few bf16 roundings of the
    reference's, in the overflowing batch."""
    rcfg, rp, cfg, pp = _layer("mixtral-8x7b", CAPACITY["overflow"])
    rcfg = dataclasses.replace(rcfg, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    x = _x(cfg)
    y_ref, _ = ref_moe.apply(rcfg, rp, jnp.asarray(x))
    y, _ = moe.apply(cfg, pp, torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(y_ref, np.float32), 2.0**-6)


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_quantization_walk_matches_reference(arch):
    """The reference's walk matches ``{"kernel": ...}`` records only: the
    expert stacks stay float and the router stays a float kernel
    (``skip_patterns``); the port's quantized tree equals the reference's,
    record for record and bit for bit."""
    rcfg, _ = _configs(arch)
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    want = bridge.params_from_numpy(
        jax.tree.map(np.asarray, ref_quantize(params, RefQuantConfig(enabled=True))), "cpu")
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = [quantize_params(layer, QuantConfig(enabled=True), f"/layers/{i}")
           for i, layer in enumerate(port["layers"])]
    def same(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    for i, (g, w) in enumerate(zip(got, want["layers"])):
        same(g, w, f"/layers/{i}")
        if "ffn" in g and "router" in g["ffn"]:
            assert set(g["ffn"]["router"]) == {"kernel"}
            assert g["ffn"]["wo"].dtype == torch.float32 and g["ffn"]["wo"].dim() == 3


# .. training ..

@functools.lru_cache(maxsize=None)
def _train_reference():
    cfg = ref_reduced(ref_get_config("mixtral-8x7b"))
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = RefSynthetic(cfg.vocab_size, seed=3).batch(0, 0, 2, 24)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(model, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(params)
    return dict(np_params=jax.tree.map(np.asarray, params), batch=batch, loss=float(loss),
                aux=float(aux["aux_loss"]), grads=jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(remat="none"):
    a = _train_reference()
    model = Model(reduced_config(get_config("mixtral-8x7b")), device="cpu")
    params = bridge.params_from_numpy(a["np_params"], device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in a["batch"].items()}
    loss, aux = loss_fn(model, params, batch, remat=remat)
    loss.backward()
    return loss, aux, map_tree(lambda p: p.grad, params)


def test_training_loss_and_gradients_match_reference():
    """A reduced mixtral (sliding window 8, 4 experts top-2): the loss with
    the summed MoE auxiliary loss, the auxiliary loss itself and every
    gradient leaf (router and experts included) against the reference's."""
    a = _train_reference()
    loss, aux, grads = _port_loss_and_grads()
    assert a["aux"] > 0
    assert abs(float(aux["aux_loss"].detach()) - a["aux"]) <= 1e-6 * a["aux"]
    assert abs(float(loss.detach()) - a["loss"]) <= 1e-5 * abs(a["loss"])
    got = bridge.params_to_numpy(grads, like=a["np_params"])
    assert jax.tree.structure(got) == jax.tree.structure(a["grads"])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(a["grads"]),
                            jax.tree.leaves(got)):
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err <= GRAD_RTOL, f"grad {jax.tree_util.keystr(path)}: {err:.3e}"


def test_remat_full_equals_no_remat_with_moe():
    """The auxiliary loss crosses ``checkpoint`` with each group's output:
    loss and gradients bit-equal with and without recomputation."""
    loss0, aux0, g0 = _port_loss_and_grads("none")
    loss1, aux1, g1 = _port_loss_and_grads("full")
    assert torch.equal(loss0, loss1) and torch.equal(aux0["aux_loss"], aux1["aux_loss"])
    for x, y in zip(leaves(g0), leaves(g1)):
        assert torch.equal(x, y)


# .. the engine against the reference engine ..

ENGINE_CASES = {"mixtral-8x7b-ring": ("mixtral-8x7b", dict(slots=3, max_len=48)),
                "dbrx-132b-paged": ("dbrx-132b", dict(slots=3, max_len=48))}
# past the ring's 8 rows (a chunked prefill) in one prefill bucket of 16
PROMPT_LENS = (10, 11, 13, 16, 9, 14)
NEW = 6

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from repro.configs import get_config, reduced_config
    from repro.models.transformer import build_model
    from repro.runtime.serve_loop import ServeEngine
    cases, lens, new = json.loads(sys.argv[1])
    out = {}
    for name, (arch, kw) in cases.items():
        cfg = reduced_config(get_config(arch))
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        eng = ServeEngine(build_model(cfg), params, **kw)
        for n in lens:
            eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=new)
        out[name] = {str(u): v for u, v in eng.run().items()}
    print("RESULT " + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _ref_engine_streams():
    """The reference engine's greedy streams, computed in fresh processes,
    one a case, side by side (its chunked admission, which the ring's
    prompts past the window take, has been seen to depend on what ran
    before it in a test worker)."""
    procs = [ref_proc.start(_REF_SCRIPT, [json.dumps([{k: v}, PROMPT_LENS, NEW])])
             for k, v in ENGINE_CASES.items()]
    out = {}
    for proc in procs:
        out.update(ref_proc.finish(proc))
    return out


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_greedy_streams_equal_reference_engine(case):
    arch, kw = ENGINE_CASES[case]
    want = {int(u): v for u, v in _ref_engine_streams()[case].items()}
    params = ref_build(ref_reduced(ref_get_config(arch))).init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(arch))
    eng = ServeEngine(Model(cfg, device="cpu"), bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), **kw)
    assert eng.cache_kind == ("ring" if cfg.sliding_window else "paged")
    rng = np.random.default_rng(7)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=NEW)
    got = eng.run()
    diff = ref_proc.first_difference(got, want, f"{case}: ")
    assert diff is None, diff
    assert all(len(v) == NEW for v in got.values())
    eng.check_leaks()
