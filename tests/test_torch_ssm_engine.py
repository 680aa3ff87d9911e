"""The port's ServeEngine on SSM and hybrid models against the
reference's: greedy streams equal token for token on reduced
mamba2-370m and jamba-1.5-large (7 SSM + 1 attention layers a group, MoE
every other layer), paged and dense, whole and chunked admission
(``prefill_chunk``), with the same weights (``PRNGKey(0)``) and seeded
prompts.  The reference runs in a fresh process: its chunked admission
has been seen to change with what ran before it in a test worker (its
own chunked jamba test is red), while a fresh process repeats it (one
process an arch, side by side, under ``_torch_ref_proc``'s fixed
environment); the port takes its params from the same process, written
with ``np.savez``, and a failing case names the reference process's
return code and stderr, or the first uid and position where the streams
differ.  The
SSM layers' steps, batched prefill ≡ sequential decode, row 8p, spec
rollback, retries and parking are held in
``tests/test_torch_ssm_serve.py``."""

import functools
import json
import os
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_ref_proc as ref_proc  # noqa: E402
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
    cases, lens, new, params_path = json.loads(sys.argv[1])
    out = {}
    for name, (arch, kw) in cases.items():
        cfg = reduced_config(get_config(arch))
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        np.savez(params_path, **{"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                          for k in path): np.asarray(v) for path, v in flat})
        rng = np.random.default_rng(7)
        eng = ServeEngine(build_model(cfg), params, **kw)
        for n in lens:
            eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=new)
        out[name] = {str(u): v for u, v in eng.run().items()}
    print("RESULT " + json.dumps(out))
""")


def _unflatten(flat):
    """{"a/b/0/c": array} -> the reference's nested tree (``groups`` a tuple)."""
    tree = {}
    for key, a in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[k]) for k in sorted(node, key=int))
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference engine's greedy streams for every ENGINE_CASES entry
    and each arch's params, computed in fresh processes (one an arch, run
    side by side) under ``_torch_ref_proc``'s fixed environment: the port
    takes its params from the same process, so nothing of this worker's
    JAX state plays a part."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for arch in sorted({a for a, _ in ENGINE_CASES.values()}):
            cases = {k: v for k, v in ENGINE_CASES.items() if v[0] == arch}
            path = os.path.join(tmp, f"{arch}.npz")
            procs[arch] = (path, ref_proc.start(
                _REF_SCRIPT, [json.dumps([cases, PROMPT_LENS, NEW, path])]))
        streams, params = {}, {}
        for arch, (path, proc) in procs.items():
            streams.update(ref_proc.finish(proc))
            with np.load(path) as data:
                params[arch] = _unflatten({k: data[k] for k in data.files})
    return streams, params


@functools.lru_cache(maxsize=None)
def _port(arch):
    cfg = reduced_config(get_config(arch))
    return cfg, bridge.params_from_numpy(_reference()[1][arch], "cpu")


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_greedy_streams_equal_reference_engine(case):
    arch, kw = ENGINE_CASES[case]
    want = {int(u): v for u, v in _reference()[0][case].items()}
    cfg, params = _port(arch)
    eng = ServeEngine(Model(cfg, device="cpu"), params, **kw)
    rng = np.random.default_rng(7)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=NEW)
    got = eng.run()
    diff = ref_proc.first_difference(got, want, f"{case}: ")
    assert diff is None, diff
    assert all(len(v) == NEW for v in got.values())
    eng.check_leaks()
    if eng.cache_kind == "paged":
        assert eng.page_stats["free"] == eng.page_stats["total"]
