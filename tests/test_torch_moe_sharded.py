"""The port's expert-parallel MoE layer (``moe.apply_sharded``) and its
rank-major layout on the CPU, against the reference and the port's
single-device layer.

``apply_sharded`` on a (2, 4) gloo world of 8 against the reference's on 8
host devices (the inputs of ``tests/test_distributed.py``: 4 experts over
model 4, batch over data 2), and with fewer experts than model ranks
(2 over 4: each expert split over R = 2 ranks along d_ff) against
``moe.apply``; in bf16 on a (1, 1) mesh against ``moe.apply`` within the
limit the card's phase 15 uses, with the planted fault "one expert's gate
dropped from the combine" over it; ``rank_major_params`` against the
reference's, bit for bit.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import _torch_dist_worker as dw  # noqa: E402
import _torch_ref_proc as ref_proc  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge, sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@pytest.fixture
def world1(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


REF_MOE = dict(name="t", family="moe", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
               d_ff=64, vocab_size=128, param_dtype="float32", compute_dtype="float32")
# name -> MoE config: the reference test's (4 experts over model 4: one a
# rank) and fewer experts than model ranks (2 over 4: R = 2)
MOE_CASES = {"ep": dict(num_experts=4, top_k=2, capacity_factor=2.0),
             "split": dict(num_experts=2, top_k=1, capacity_factor=2.0)}

_REF_APPLY_SHARDED = """
import sys, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import moe
assert len(jax.devices()) == 8
spec = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = ModelConfig(**spec["model"], moe=MoEConfig(**spec["moe"]))
p = moe.init(jax.random.PRNGKey(0), cfg)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
with mesh:
    y, aux = jax.jit(lambda p, x: moe.apply_sharded(cfg, p, x, mesh, "data"))(p, x)
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
print("RESULT " + json.dumps({"aux": float(aux)}))
"""


@pytest.fixture(scope="module")
def world24(tmp_path_factory):
    """The (2, 4) world's apply_sharded beside the reference's on 8 host
    devices (a fresh process, run at the same time)."""
    tmp = tmp_path_factory.mktemp("w24")
    inputs, configs = {}, {}
    for name, kw in MOE_CASES.items():
        cfg = ref_base.ModelConfig(**REF_MOE, moe=ref_base.MoEConfig(**kw))
        p = ref_moe.init(jax.random.PRNGKey(0), cfg)
        inputs[f"{name}/x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32)))
        inputs[f"{name}/p/router/kernel"] = np.asarray(p["router"]["kernel"])
        for w in ("wi_gate", "wi_up", "wo"):
            inputs[f"{name}/p/{w}"] = np.asarray(p[w])
        configs[name] = {"model": REF_MOE, "moe": kw}
    np.savez(tmp / "inputs.npz", **inputs)
    env = ref_proc.ref_env()
    # first: XLA stops reading its flags at the bare intra_op_parallelism_threads
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + env["XLA_FLAGS"]
    spec = json.dumps(configs["ep"])
    proc = subprocess.Popen([sys.executable, "-c", _REF_APPLY_SHARDED, spec,
                             str(tmp / "ref.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = dw.run_world("moe", 8, tmp, shape=(2, 4), inputs=str(tmp / "inputs.npz"),
                            configs=configs)
    finally:
        ref = ref_proc.finish(proc)
    with np.load(tmp / "ref.npz") as f:
        ref = dict(y=f["y"], aux=f["aux"])
    return inputs, configs, port, ref


def test_apply_sharded_matches_reference(world24):
    """4 experts over model 4, batch over data 2: y within the reference
    test's atol 2e-5 / rtol 1e-4 of the reference's ``apply_sharded``, aux
    (per data shard, then averaged) within rtol 1e-5."""
    _, _, port, ref = world24
    for r in port[1:]:
        assert np.array_equal(r["ep/y"], port[0]["ep/y"])
        assert r["ep/aux"] == port[0]["ep/aux"]
    np.testing.assert_allclose(port[0]["ep/y"], ref["y"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(float(port[0]["ep/aux"]), float(ref["aux"]), rtol=1e-5)


def test_apply_sharded_splits_experts_over_ranks(world24):
    """2 experts over model 4 (each split over R = 2 ranks along d_ff):
    y against the port's single-device ``moe.apply`` (dropless) within the
    same limits."""
    inputs, configs, port, _ = world24
    from repro_torch.configs.base import ModelConfig, MoEConfig
    cfg = ModelConfig(**REF_MOE, moe=MoEConfig(**MOE_CASES["split"]))
    assert cfg.moe.num_experts < 4
    p = {"router": {"kernel": torch.from_numpy(inputs["split/p/router/kernel"])},
         **{w: torch.from_numpy(inputs[f"split/p/{w}"]) for w in ("wi_gate", "wi_up", "wo")}}
    y, _ = moe.apply(cfg, p, torch.from_numpy(inputs["split/x"]))
    np.testing.assert_allclose(port[0]["split/y"], y.numpy(), atol=2e-5, rtol=1e-4)


# bf16 limit of apply_sharded against moe.apply, relative L2 over a whole
# output or gradient; chip_smoke.py's MOE_SHARDED_RTOL is this number.
# The two paths compute the same bf16 products, but apply_sharded weighs
# and sums a token's experts in f32 and rounds once, where moe.apply rounds
# each weighted row to bf16 and sums the k rows in bf16; and on the card
# the expert products (one matmul an expert against one bmm over all) may
# accumulate in other orders, so an output element may round one bf16 ulp
# apart (2^-8 relative; a relative L2 of ~2^-9..2^-8 over a tensor).  The
# limit leaves a factor of 4 over one ulp everywhere: 2^-6.  Measured on
# the CPU: 3.4e-3 .. 3.6e-3 (y), up to 5.3e-3 (gradients); dropping one
# expert's gate from the combine reads 0.1 .. 0.4.
MOE_BF16_RTOL = 2.0**-6
MOE_BF16 = dict(name="bf16", family="moe", num_layers=1, d_model=256, num_heads=4,
                num_kv_heads=4, d_ff=512, vocab_size=128, param_dtype="bfloat16",
                compute_dtype="bfloat16")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("t", [8, 512])
def test_apply_sharded_bf16_within_limit_of_apply(world1, t):
    """mixtral's MoE shape at a reduced width (8 experts, top-2, capacity
    factor 1.25, bf16) on the (1, 1) mesh: y (and at T = 512 the input and
    expert gradients under one seeded cotangent) within MOE_BF16_RTOL of
    ``moe.apply``; the planted fault "one expert's gate dropped from the
    combine" (``moe.route`` with expert 0's gates zeroed) far over it."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    cfg = ModelConfig(**MOE_BF16, moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25))
    gen = torch.Generator().manual_seed(3)
    p = moe.init(gen, cfg)
    shape = (t, 1, cfg.d_model) if t <= 8 else (1, t, cfg.d_model)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen).to(torch.bfloat16)
    experts = ("wi_gate", "wi_up", "wo")
    out = {}
    for label, fn in (("sharded", lambda v: moe.apply_sharded(cfg, p, v, world1, "data")),
                      ("plain", lambda v: moe.apply(cfg, p, v))):
        xg = x.clone().requires_grad_(True)
        for n in experts:
            p[n].requires_grad_(True)
            p[n].grad = None
        y, aux = fn(xg)
        y.backward(dy)
        out[label] = {"y": y.detach(), "aux": aux.detach(), "x": xg.grad,
                      **{n: p[n].grad for n in experts}}
    for n in experts:
        p[n].requires_grad_(False)
    assert moe.capacity(cfg, t) == (3 if t == 8 else 160)
    assert torch.equal(out["sharded"]["aux"], out["plain"]["aux"])
    for k in ("y",) + (("x",) + experts if t > 8 else ()):
        err = _rel_l2(out["sharded"][k], out["plain"][k])
        assert 0 < err <= MOE_BF16_RTOL, (k, err)
    real = moe.route

    def dropped(cfg_, p_, xt, rows=False):
        probs, gates, idx = real(cfg_, p_, xt, rows)
        return probs, gates.masked_fill(idx == 0, 0.0), idx

    moe.route = dropped
    try:
        with torch.no_grad():
            yf, _ = moe.apply_sharded(cfg, p, x, world1, "data")
    finally:
        moe.route = real
    assert _rel_l2(yf, out["plain"]["y"]) > 4 * MOE_BF16_RTOL


# --- rank-major layout -----------------------------------------------------

@pytest.mark.parametrize("m", [2, 8])
def test_rank_major_params_match_reference(m):
    """E = 4 experts: over model 2 the layout is unchanged (pure EP), over
    model 8 each expert's d_ff splits over R = 2 ranks; bit for bit."""
    cfg = ref_reduced(ref_get_config("mixtral-8x7b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    want = bridge.params_from_numpy(
        jax.tree.map(np.asarray, ref_moe.rank_major_params(params, m)), "cpu")
    got = moe.rank_major_params(bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                                         "cpu"), m)
    pairs = list(zip(sharding.tree_paths(got), sharding.tree_paths(want)))
    assert len(pairs) == len(sharding.tree_paths(want))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.shape == b.shape and torch.equal(a, b), pa
    wi = got["layers"][0]["ffn"]["wi_gate"]
    assert wi.shape[0] == max(m, 4)
