"""The port's ServeEngine on SSM and hybrid models against the
reference's: greedy streams equal token for token on reduced
mamba2-370m and jamba-1.5-large (7 SSM + 1 attention layers a group, MoE
every other layer), paged and dense, whole and chunked admission
(``prefill_chunk``), with the same weights (``PRNGKey(0)``) and seeded
prompts.  The reference runs in a fresh process: its chunked admission
has been seen to change with what ran before it in a test worker (its
own chunked jamba test is red), while a fresh process repeats it (one
process an arch, side by side).  The
SSM layers' steps, batched prefill ≡ sequential decode, row 8p, spec
rollback, retries and parking are held in
``tests/test_torch_ssm_serve.py``."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

ENGINE_CASES = {
    "mamba2-370m-paged-chunked": ("mamba2-370m", dict(slots=3, max_len=48, prefill_chunk=4)),
    "mamba2-370m-dense": ("mamba2-370m", dict(slots=2, max_len=48, cache_kind="dense")),
    "jamba-1.5-large-paged": ("jamba-1.5-large", dict(slots=3, max_len=48)),
    "jamba-1.5-large-dense-chunked": ("jamba-1.5-large",
                                      dict(slots=2, max_len=48, cache_kind="dense",
                                           prefill_chunk=4)),
}
PROMPT_LENS = (5, 7, 3, 8, 6, 4)   # one prefill bucket: one compile a reference engine
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
    print(json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _ref_engine_streams():
    """The reference engine's greedy streams for every ENGINE_CASES entry,
    computed in fresh processes, one an arch, run side by side."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = []
    for arch in sorted({a for a, _ in ENGINE_CASES.values()}):
        cases = {k: v for k, v in ENGINE_CASES.items() if v[0] == arch}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, json.dumps([cases, PROMPT_LENS, NEW])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


@functools.lru_cache(maxsize=None)
def _port(arch):
    params = ref_build(ref_reduced(ref_get_config(arch))).init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(arch))
    return cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_greedy_streams_equal_reference_engine(case):
    arch, kw = ENGINE_CASES[case]
    want = {int(u): v for u, v in _ref_engine_streams()[case].items()}
    cfg, params = _port(arch)
    eng = ServeEngine(Model(cfg, device="cpu"), params, **kw)
    rng = np.random.default_rng(7)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=NEW)
    got = eng.run()
    assert got == want
    assert all(len(v) == NEW for v in got.values())
    eng.check_leaks()
    if eng.cache_kind == "paged":
        assert eng.page_stats["free"] == eng.page_stats["total"]
