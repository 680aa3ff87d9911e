"""The port's GPipe pipeline against the reference's: ``bubble_fraction``
equal to the reference's, and ``pipeline_apply`` on a 4-stage gloo world
(num_micro 4 and 8) against the reference's ``pipeline_apply`` on 4 host
devices in a fresh process, with the inputs of ``tests/test_pipeline.py``
(4 tanh-MLP stages of width 16, 8 rows), within its atol 1e-5.  Both
compute the same float32 stage products; the reference's masked psum and
the port's sum of zeros and the last stage's buffer add exact zeros.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_worker as dw  # noqa: E402
import _torch_ref_proc as ref_proc  # noqa: E402
from repro.runtime.pipeline import bubble_fraction as ref_bubble  # noqa: E402
from repro_torch.runtime.pipeline import bubble_fraction  # noqa: E402

MICROS = (4, 8)

_REF = """
import sys, json
import jax, jax.numpy as jnp, numpy as np
from repro.runtime.pipeline import pipeline_apply
assert len(jax.devices()) == 4
mesh = jax.make_mesh((4,), ("stage",))
S, D = 4, 16

def stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])

key = jax.random.PRNGKey(0)
params = {"w": jax.random.normal(key, (S, D, D)) * 0.3, "b": jnp.zeros((S, D))}
x = jax.random.normal(jax.random.PRNGKey(1), (8, D))
y_ref = x
for s in range(S):
    y_ref = stage_fn({"w": params["w"][s], "b": params["b"][s]}, y_ref)
out = {"w": np.asarray(params["w"]), "b": np.asarray(params["b"]), "x": np.asarray(x),
       "seq": np.asarray(y_ref)}
for m in (4, 8):
    with mesh:
        out[f"y{m}"] = np.asarray(jax.jit(lambda p, x: pipeline_apply(
            stage_fn, p, x, mesh=mesh, num_micro=m))(params, x))
np.savez(sys.argv[1], **out)
print("RESULT " + json.dumps({"ok": True}))
"""


@pytest.mark.parametrize("m,s", [(1, 4), (16, 4), (64, 2), (4, 4), (8, 4), (3, 1)])
def test_bubble_fraction_matches_reference(m, s):
    assert bubble_fraction(m, s) == ref_bubble(m, s)


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    env = ref_proc.ref_env()
    # first: XLA stops reading its flags at the bare intra_op_parallelism_threads
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " + env["XLA_FLAGS"]
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(tmp / "ref.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ref_proc.finish(proc)
    with np.load(tmp / "ref.npz") as f:
        ref = {k: f[k] for k in f.files}
    port = dw.run_world("pipeline", 4, tmp, inputs=str(tmp / "ref.npz"), micros=MICROS)
    return ref, port


@pytest.mark.parametrize("m", MICROS)
def test_pipeline_apply_matches_reference(pipeline_runs, m):
    ref, port = pipeline_runs
    for rank, res in enumerate(port):        # every stage holds the outputs
        assert np.array_equal(res[f"y{m}"], port[0][f"y{m}"]), rank
    np.testing.assert_allclose(port[0][f"y{m}"], ref[f"y{m}"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port[0][f"y{m}"], ref["seq"], atol=1e-5, rtol=1e-5)


def test_microbatch_count_changes_nothing(pipeline_runs):
    """The same rows through the same stages: only the row count of each
    product differs (2 rows a microbatch against 1), which may change a
    matmul's summation order, so within float32 roundings."""
    _, port = pipeline_runs
    np.testing.assert_allclose(port[0]["y4"], port[0]["y8"], atol=1e-6, rtol=1e-6)
