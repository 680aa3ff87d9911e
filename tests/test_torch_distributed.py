"""The port's multi-device path on gloo worlds on the CPU, against the port's
single-device path and the reference.

(a) the sharded train step of reduced qwen2.5-3b on a (2, 2) (data,
model) mesh, without and with microbatches, against the port's
single-device step and the reference's; (b) on a (1, 1) mesh, bit for bit
the plain step; (c) reduced mixtral-8x7b's sharded step (expert-parallel
MoE, no auxiliary loss, dropless) against the single-device step, and the
planted fault "the combine's cotangent summed over the model axis again"
over the limits; (f) reduced mixtral's decode step on (2, 2) with the
serve_tp layout, logits against the reference's single-device step; the
``torchrun`` launch of a 2x2 mesh against ``--mesh 1x1``, its checkpoint
restored into a 1x1 run; a larger mesh without ``torchrun`` refused.
The MoE layer itself ((d) ``apply_sharded`` against the reference's on a
world of 8, (e) ``rank_major_params``, and its bf16 limit) is in
``tests/test_torch_moe_sharded.py``, which keeps each file's time under
a minute in the parallel run.

Tolerances.  A step on the mesh computes the same float32 math as on one
device, except that each data shard sums its own rows' gradient and the
shards' sums are then added (and the loss is the mean of the shards'
means): the sum over rows runs in another order.  Each element then
differs by a few float32 roundings of the sum's larger terms, ~1e-7 of
the leaf's largest gradient (measured: under 2e-7 here), so SHARD_RTOL
= 1e-6 of each leaf's largest element.  AdamW's first step turns a
gradient g into lr g / (|g| + eps), so a weight may move by lr times the
gradient's difference times that slope (at most 2 lr, a flipped sign),
as ``tests/test_torch_train.py`` reasons; m and v are held to SHARD_RTOL
of their leaf's largest element.  Against the reference, its
GRAD_RTOL = 1e-5 (``tests/test_torch_train.py:136``) widened by
SHARD_RTOL.  The MoE step adds the expert-parallel layer's own order (its
combine sums experts in f32 before the model-axis sum; the single-device
layer sums a token's k slots): the same bound holds.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_worker as dw  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.runtime.train_loop import init_opt_state as ref_init_opt  # noqa: E402
from repro.runtime.train_loop import make_train_step as ref_make_step  # noqa: E402
from repro_torch import bridge, sharding  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.base import OptimConfig, TrainConfig  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

SHARD_RTOL = 1e-6
REF_RTOL = 1e-5 + SHARD_RTOL
ROWS, SEQ = 4, 16
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# (microbatch in global rows, gradient compression, remat): the MoE step
# also under remat "full", whose recompute replays the layer's collectives
DENSE_RUNS = [(0, "none", "none"), (2, "none", "none")]
MOE_RUNS = [(0, "none", "none"), (2, "none", "full")]
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
HERE = os.path.dirname(os.path.abspath(__file__))


# --- the single-device side ----------------------------------------------------

def _single_step(arch, mb, comp, remat="none"):
    """The port's single-device step from ``dw.init_params``: (params, m, v
    as {path: numpy}, loss, grad-norm), and the step's gradients (m / (1 -
    beta1))."""
    cfg = dw.step_config(arch)
    model = Model(cfg, device="cpu")
    params = dw.init_params(cfg)
    tcfg = TrainConfig(seq_len=SEQ, global_batch=ROWS, microbatch=mb, grad_compression=comp,
                       remat=remat)
    opt = init_opt_state(tcfg, params)
    batch = {k: torch.from_numpy(v) for k, v in dw.token_batch(cfg.vocab_size, ROWS, SEQ).items()}
    params, opt, m = make_train_step(model, OptimConfig(**OCFG), tcfg)(params, opt, batch)
    out = {**dw.flat(params, "p"), **dw.flat(opt["adam"]["m"], "m"),
           **dw.flat(opt["adam"]["v"], "v")}
    return out, float(m["loss"]), float(m["grad_norm"])


def _check_step(got, want, rtol, what):
    """Every leaf of params, m and v against ``want`` ({"p/...", "m/...",
    "v/..."}): m, v within ``rtol`` of their leaf's largest element, the
    params within 1e-6 |w| + 1e-7 plus lr times the gradient's allowed
    difference times Adam's slope there."""
    lr, eps, b1 = OCFG["lr"], OptimConfig().eps, OptimConfig().beta1
    paths = [k[2:] for k in want if k.startswith("p/")]
    assert paths and all(f"p/{p}" in got for p in paths), sorted(got)[:5]
    worst = 0.0
    for path in paths:
        g = want[f"m/{path}"] / (1 - b1)
        dg = rtol * (np.abs(g).max() + 1e-30)
        slope = eps / (np.maximum(np.abs(g) - dg, 0.0) + eps) ** 2
        for k in ("m", "v"):
            a, w = got[f"{k}/{path}"], want[f"{k}/{path}"]
            err = np.abs(a - w).max() / (np.abs(w).max() + 1e-30)
            worst = max(worst, err) if k == "m" else worst
            assert err <= rtol, f"{what}: {k} {path} {err:.3e} > {rtol}"
        a, w = got[f"p/{path}"], want[f"p/{path}"]
        tol = 1e-7 + 1e-6 * np.abs(w) + lr * np.minimum(2.0, dg * slope)
        bad = np.abs(a - w) > tol
        assert not bad.any(), (what, path, np.abs(a - w)[bad][:5])
    return worst


def _rank0(results, prefix):
    """{key without ``prefix``/: array} of rank 0, after checking that every
    rank gathered the same numbers."""
    for r in results[1:]:
        for k, v in results[0].items():
            if k.startswith(prefix + "/") and not k.endswith("local_bytes"):
                assert np.array_equal(r[k], v), k
    return {k[len(prefix) + 1:]: v for k, v in results[0].items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def world22(tmp_path_factory):
    """One (2, 2) world for every step case and the decode."""
    steps = {"dense": ("qwen2.5-3b", DENSE_RUNS, ROWS, SEQ, OCFG, False),
             "moe": ("mixtral-8x7b", MOE_RUNS, ROWS, SEQ, OCFG, False),
             "moe_fault": ("mixtral-8x7b", MOE_RUNS[:1], ROWS, SEQ, OCFG, True)}
    return dw.run_world("steps", 4, tmp_path_factory.mktemp("w22"), shape=(2, 2), steps=steps,
                        decode=("mixtral-8x7b", 4, 8))


# --- (a) dense sharded step ----------------------------------------------------

@pytest.mark.parametrize("mb,comp,remat", DENSE_RUNS)
def test_dense_sharded_step_matches_single_device(world22, mb, comp, remat):
    got = _rank0(world22, f"dense/qwen2.5-3b/{mb}/{comp}/{remat}")
    want, loss, gnorm = _single_step("qwen2.5-3b", mb, comp, remat)
    worst = _check_step(got, want, SHARD_RTOL, "dense (2, 2)")
    assert worst > 0.0        # the data-axis sum really runs in another order
    assert abs(float(got["loss"]) - loss) <= SHARD_RTOL * abs(loss)
    assert abs(float(got["grad_norm"]) - gnorm) <= SHARD_RTOL * gnorm
    full = sum(v.nbytes for k, v in want.items() if k.startswith("p/"))
    local = [int(r[f"dense/qwen2.5-3b/{mb}/{comp}/{remat}/local_bytes"]) for r in world22]
    assert max(local) < 0.5 * full      # each rank stores a part of the params


@pytest.fixture(scope="module")
def qwen_reference():
    cfg = ref_reduced(ref_get_config("qwen2.5-3b"))
    like = jax.tree.map(np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))
    return cfg, like


@pytest.mark.parametrize("mb,comp,remat", DENSE_RUNS)
def test_dense_sharded_step_matches_reference(world22, qwen_reference, mb, comp, remat):
    cfg, like = qwen_reference
    pcfg = dw.step_config("qwen2.5-3b")
    params = bridge.params_to_numpy(dw.init_params(pcfg), like)
    batch = dw.token_batch(pcfg.vocab_size, ROWS, SEQ)
    tcfg = ref_base.TrainConfig(seq_len=SEQ, global_batch=ROWS, microbatch=mb,
                                grad_compression=comp, remat=remat)
    rp, ropt, rm = jax.jit(ref_make_step(ref_build(cfg), ref_base.OptimConfig(**OCFG), tcfg))(
        params, ref_init_opt(tcfg, params), jax.tree.map(jnp.asarray, batch))
    got = _rank0(world22, f"dense/qwen2.5-3b/{mb}/{comp}/{remat}")
    want = {}
    for k, tree in (("p", rp), ("m", ropt["adam"]["m"]), ("v", ropt["adam"]["v"])):
        port_tree = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
        want.update(dw.flat(port_tree, k))
    _check_step(got, want, REF_RTOL, "dense (2, 2) vs reference")
    assert abs(float(got["loss"]) - float(rm["loss"])) <= REF_RTOL * abs(float(rm["loss"]))


# --- (b) the (1, 1) mesh -------------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("mb,comp,cdt", [(0, "none", "float32"), (2, "none", "float32"),
                                         (2, "int8_ef", "float32"), (2, "none", "bfloat16")])
def test_one_by_one_mesh_is_the_plain_step_bit_for_bit(world1, mb, comp, cdt):
    """As the reference's ``test_dp_tp_parity`` intends: the sharded step on
    a (1, 1) mesh (real collectives over groups of one) gives the plain
    step's loss, grad-norm, params, m, v (and ef) bit for bit; in bf16
    compute too (the step gathers bf16 copies of the float32 masters, as
    the plain step's loss casts them)."""
    cfg = dataclasses.replace(dw.step_config("qwen2.5-3b"), compute_dtype=cdt)
    tcfg = TrainConfig(seq_len=SEQ, global_batch=ROWS, microbatch=mb, grad_compression=comp)
    batch = {k: torch.from_numpy(v) for k, v in dw.token_batch(cfg.vocab_size, ROWS, SEQ).items()}
    runs = []
    for sharded in (False, True):
        params = dw.init_params(cfg)
        if sharded:
            model = Model(cfg, device="cpu", dist=(world1, "data"))
            specs = sharding.params_shardings(params, world1)
            params = sharding.local_shard_tree(params, specs, world1)
            step = make_train_step(model, OptimConfig(**OCFG), tcfg, data_axes="data",
                                   grad_shardings=specs)
        else:
            step = make_train_step(Model(cfg, device="cpu"), OptimConfig(**OCFG), tcfg)
        opt = init_opt_state(tcfg, params)
        params, opt, m = step(params, opt, batch)
        runs.append((params, opt, m))
    (p1, o1, m1), (p2, o2, m2) = runs
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    for name, a, b in (("p", p1, p2), ("m", o1["adam"]["m"], o2["adam"]["m"]),
                       ("v", o1["adam"]["v"], o2["adam"]["v"])) + (
            (("ef", o1["ef"], o2["ef"]),) if comp == "int8_ef" else ()):
        for (path, x), (_, y) in zip(sharding.tree_paths(a), sharding.tree_paths(b)):
            assert torch.equal(x, y), (name, path)


# --- (c) MoE sharded step ------------------------------------------------------

@pytest.mark.parametrize("mb,comp,remat", MOE_RUNS)
def test_moe_sharded_step_matches_single_device(world22, mb, comp, remat):
    got = _rank0(world22, f"moe/mixtral-8x7b/{mb}/{comp}/{remat}")
    want, loss, gnorm = _single_step("mixtral-8x7b", mb, comp, remat)
    assert any("ffn/wi_gate" in k for k in want)
    _check_step(got, want, SHARD_RTOL, "moe (2, 2)")
    assert abs(float(got["loss"]) - loss) <= SHARD_RTOL * abs(loss)
    assert abs(float(got["grad_norm"]) - gnorm) <= SHARD_RTOL * gnorm


def test_planted_fault_cotangent_summed_twice_fails(world22):
    """The combine's cotangent summed over the model axis a second time
    doubles every gradient behind the MoE layers (M = 2): m and the
    grad-norm read far over the limits."""
    got = _rank0(world22, "moe_fault/mixtral-8x7b/0/none/none")
    want, _, gnorm = _single_step("mixtral-8x7b", 0, "none")
    with pytest.raises(AssertionError):
        _check_step(got, want, SHARD_RTOL, "moe fault")
    assert abs(float(got["grad_norm"]) - gnorm) > 100 * SHARD_RTOL * gnorm
    worst = max(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
                for k in want if k.startswith("m/"))
    assert worst > 1e4 * SHARD_RTOL, worst


# --- (f) decode on a mesh ------------------------------------------------------

def test_decode_on_mesh_matches_reference(world22):
    """Reduced mixtral's first decode step on (2, 2): params kept by the
    serve_tp profile (each rank a part) and gathered, the rank's 2 of 4
    rows, MoE expert-parallel; the logits gathered over data within the
    reference test's atol 2e-4 / rtol 2e-3 of the reference's single-device
    ``decode_step``."""
    pcfg = dw.moe_config("mixtral-8x7b")
    cfg = ref_reduced(ref_get_config("mixtral-8x7b"))
    ref = ref_build(cfg)
    like = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = bridge.params_to_numpy(dw.init_params(pcfg), like)
    logits, _ = ref.decode_step(params, ref.init_cache(4, 8), tokens=jnp.ones((4,), jnp.int32))
    got = world22[0]["decode/logits"]
    for r in world22[1:]:
        assert np.array_equal(r["decode/logits"], got)
    np.testing.assert_allclose(got, np.asarray(logits), atol=2e-4, rtol=2e-3)
    full = sum(t.numel() * 4 for _, t in sharding.tree_paths(dw.init_params(pcfg)))
    assert int(world22[0]["decode/kept_bytes"]) < full


# --- the launch ------------------------------------------------------------------

def _step_lines(text):
    return [ln.split() for ln in text.splitlines() if ln.startswith("step ")]


def test_launch_mesh_2x2_matches_1x1_and_its_checkpoint_restores(tmp_path, capsys):
    """``torchrun`` with 4 gloo ranks on a 2x2 mesh (2 steps, a checkpoint
    after step 2) prints the 1x1 run's step lines (loss to 4 decimals,
    grad-norm to 2: within SHARD_RTOL); the checkpoint holds the full tree
    in the single-device layout, and a 1x1 run resumes from it."""
    args = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "2",
            "--log-every", "1"]
    env = {"PYTHONPATH": os.path.abspath(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", str(tmp_path))}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", os.path.join(HERE, "_torch_dist_worker.py"), *args, "--mesh", "2x2",
         "--ckpt", str(tmp_path / "ck")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    straight = port_train.main(args[:-4] + ["--steps", "3", "--log-every", "1"])
    one = capsys.readouterr().out
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    mesh_lines, one_lines = _step_lines(out), _step_lines(one)
    assert len(mesh_lines) == 2, out
    for a, b in zip(mesh_lines, one_lines):
        assert a[:3] == b[:3]                     # step number, "loss"
        assert abs(float(a[3]) - float(b[3])) <= 1e-4 + SHARD_RTOL * abs(float(b[3]))
        assert abs(float(a[7]) - float(b[7])) <= 0.01 + SHARD_RTOL * abs(float(b[7]))
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.latest_step() == 2
    # the full tree after step 2, leaf for leaf against a 1x1 run's
    cfg = port_train.reduced_config(port_train.get_config("qwen2.5-3b"))
    tcfg = TrainConfig(seq_len=128, global_batch=8, remat="full")
    ocfg = port_train.get_optim("qwen2.5-3b")
    _, params, opt, step = port_train.build(cfg, tcfg, ocfg, seed=0, device="cpu")
    stream = port_train.TokenStream(port_train.SyntheticSource(cfg.vocab_size, seed=1234),
                                    global_batch=8, seq_len=128)
    params, opt, recs = port_train.train(step, params, opt, stream, 2, device="cpu",
                                         log_every=0)
    state = {"params": params, "opt": opt}
    restored = ck.restore(2, state)
    lr_sum = sum(r["lr"] for r in recs)
    assert restored["opt"]["adam"]["step"] == 2
    for (path, a), (_, b) in zip(sharding.tree_paths(restored), sharding.tree_paths(state)):
        if not isinstance(b, torch.Tensor):
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "/m/" in path or "/v/" in path:
            tol = 10 * SHARD_RTOL * float(b.detach().abs().max()) + 1e-30
        else:   # each Adam step may move a weight by up to 2 lr on a flipped sign
            tol = 2 * lr_sum + 1e-6 * float(b.detach().abs().max())
        assert float((a - b.detach()).abs().max()) <= tol, path
    resumed = port_train.main(args[:-4] + ["--steps", "3", "--ckpt", str(tmp_path / "ck"),
                                           "--log-every", "1"])
    assert "resuming from checkpoint step 2" in capsys.readouterr().out
    assert [r["step"] for r in resumed] == [3]
    assert abs(resumed[0]["loss"] - straight[2]["loss"]) <= 10 * SHARD_RTOL * straight[2]["loss"]


def test_launch_mesh_without_torchrun_raises(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        port_train.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--mesh", "2x2",
                         "--steps", "1"])
    assert not torch.distributed.is_initialized()


def test_parse_mesh_matches_reference():
    from repro.launch.train import parse_mesh as ref_parse
    for spec in ("1x1", "2x2", "16x16", "2x16x16"):
        assert port_train.parse_mesh(spec) == ref_parse(spec)
