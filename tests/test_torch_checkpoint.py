"""The port's checkpointer (``repro_torch/checkpoint/checkpointer.py``) and
``launch/train.py``'s resume.

* the reference's ``TestCheckpointer`` cases (``tests/test_substrates.py``)
  on torch trees;
* interchange: a checkpoint written by either package restores in the
  other bit for bit (nested dicts and lists with float32, bfloat16 and
  integer leaves, and an AdamW-shaped state with its step);
* resume ≡ uninterrupted: N train steps against k steps, a save and a
  restore into a fresh build, then N - k steps: params, m, v and step
  bit-identical (plain path, CPU);
* the CLI with ``--ckpt``: 4 steps, then resumed to 6, gives the records
  of an uninterrupted 6-step run (``TrainConfig.checkpoint_every``
  patched from 500 to 2 in the launcher's namespace: neither CLI has a
  flag for it).
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten  # noqa: E402
from repro_torch.configs import get_config, get_optim, reduced_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource, TokenStream  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


# .. the reference's TestCheckpointer, on torch trees ..

def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    ck.save(100, tree, blocking=True)
    step, back = ck.restore_latest(tree)
    assert step == 100
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["c"], tree["b"]["c"])


def test_keep_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    with open(os.path.join(str(tmp_path), "LATEST")) as f:
        assert f.read() == "4"


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.arange(100, dtype=torch.float32)}
    ck.save(5, tree, blocking=True)
    shard = os.path.join(str(tmp_path), "step_000000005", "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(120)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        ck.restore(5, tree)


def test_crash_mid_save_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.zeros(4)}
    ck.save(1, tree, blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_000000002.tmp"))
    ck2 = Checkpointer(str(tmp_path))      # restart
    assert ck2.latest_step() == 1
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000000002.tmp"))


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.arange(1000, dtype=torch.float32)}
    ck.save(7, tree, blocking=False)
    tree["x"].add_(1)                      # the snapshot was taken at save
    ck.wait()
    assert ck.latest_step() == 7
    assert torch.equal(ck.restore(7, tree)["x"], torch.arange(1000, dtype=torch.float32))
    assert ck.last_save["bytes"] == 4000 and ck.last_save["write_s"] >= 0


def test_leaf_order_is_jax_flatten_order():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": (4, None, 5), "c": {"y": 6, "x": 7}}
    assert flatten(tree) == jax.tree_util.tree_leaves(tree)


def test_shape_and_structure_mismatch_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"x": torch.zeros(5)})
    with pytest.raises(ValueError, match="structure"):
        ck.restore(1, {"x": torch.zeros(4), "y": torch.zeros(1)})


# .. interchange with the reference ..

def _arrays(seed=0):
    """The shared tree's values as numpy (bf16 leaves as float32 that
    bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: (rng.standard_normal(s).astype(np.float32)   # noqa: E731
                     .view(np.uint32) & 0xFFFF0000).view(np.float32)
    return {
        "params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                   "emb": bf(5, 2),
                   "layers": [{"a": rng.standard_normal(7).astype(np.float32),
                               "bias": bf(3)},
                              {"a": rng.standard_normal(7).astype(np.float32),
                               "bias": bf(3)}]},
        "ids": rng.integers(-1000, 1000, 6).astype(np.int32),
        "opt": {"adam": {"m": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
                         "v": {"w": rng.random((3, 4)).astype(np.float32)},
                         "step": 17}},
    }


BF16_KEYS = ("emb", "bias")


def _tree(arrays, leaf, key=None):
    if isinstance(arrays, dict):
        return {k: _tree(v, leaf, k) for k, v in arrays.items()}
    if isinstance(arrays, list):
        return [_tree(v, leaf, key) for v in arrays]
    return leaf(arrays, key)


def _port_leaf(a, key):
    if key == "step":
        return int(a)
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if key in BF16_KEYS else t


def _ref_leaf(a, key):
    if key == "step":
        return jnp.asarray(a, jnp.int32)
    return jnp.asarray(a, jnp.bfloat16 if key in BF16_KEYS else None)


def _same(port, ref):
    """Every leaf bit for bit, bf16 included; the step an int == the
    reference's int32 scalar."""
    pl, rl = flatten(port), jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = np.asarray(r)
        if isinstance(p, int):
            assert type(p) is int and r.dtype == np.int32 and p == int(r)
            continue
        if p.dtype == torch.bfloat16:
            assert r.dtype.name == "bfloat16"
            np.testing.assert_array_equal(p.view(torch.uint16).numpy(), r.view(np.uint16))
        else:
            assert str(p.dtype).removeprefix("torch.") == str(r.dtype)
            np.testing.assert_array_equal(p.numpy(), r)


def test_reference_checkpoint_restores_in_port(tmp_path):
    arrays = _arrays(1)
    ref_tree = _tree(arrays, _ref_leaf)
    RefCheckpointer(str(tmp_path)).save(3, ref_tree, blocking=True)
    like = _tree(_arrays(2), _port_leaf)
    step, got = Checkpointer(str(tmp_path)).restore_latest(like)
    assert step == 3
    _same(got, ref_tree)
    assert isinstance(got["params"]["layers"], list)


def test_port_checkpoint_restores_in_reference(tmp_path):
    arrays = _arrays(3)
    port_tree = _tree(arrays, _port_leaf)
    Checkpointer(str(tmp_path)).save(9, port_tree, blocking=True)
    like = _tree(_arrays(4), _ref_leaf)
    step, got = RefCheckpointer(str(tmp_path)).restore_latest(like)
    assert step == 9
    _same(port_tree, got)
    with open(tmp_path / "step_000000009" / "manifest.json") as f:
        manifest = json.load(f)
    dtypes = [leaf["dtype"] for leaf in manifest["leaves"]]
    assert dtypes.count("bfloat16") == 3 and "int32" in dtypes


def test_manifests_agree(tmp_path):
    """Both packages write the same manifest (step, shapes, dtypes; the
    checksums differ with the zip entries' timestamps) and the same bytes
    in every shard member."""
    arrays = _arrays(5)
    Checkpointer(str(tmp_path / "port")).save(2, _tree(arrays, _port_leaf), blocking=True)
    RefCheckpointer(str(tmp_path / "ref")).save(2, _tree(arrays, _ref_leaf), blocking=True)
    manifests, members = [], []
    for who in ("port", "ref"):
        d = tmp_path / who / "step_000000002"
        with open(d / "manifest.json") as f:
            manifests.append(json.load(f))
        del manifests[-1]["checksum"]
        with np.load(d / "shard_00000.npz") as data:
            members.append({k: data[k].tobytes() for k in data.files})
    assert manifests[0] == manifests[1]
    assert members[0] == members[1]


# .. resume ≡ uninterrupted ..

def _small():
    cfg = reduced_config(get_config("minicpm-2b"))
    tcfg = TrainConfig(seq_len=32, global_batch=2)
    return cfg, tcfg, get_optim("minicpm-2b")


def _run(step_fn, params, opt, stream, steps, start=0):
    return launch.train(step_fn, params, opt, stream, steps, device=torch.device("cpu"),
                        log_every=10**9, start=start)


def test_resume_equals_uninterrupted(tmp_path):
    cfg, tcfg, ocfg = _small()
    n, k = 4, 2
    stream = lambda start: TokenStream(SyntheticSource(cfg.vocab_size, seed=1234),  # noqa: E731
                                       global_batch=2, seq_len=32, start_step=start)
    _, params, opt, step_fn = launch.build(cfg, tcfg, ocfg, seed=0, device="cpu")
    want_p, want_o, want_r = _run(step_fn, params, opt, stream(0), n)

    _, params, opt, step_fn = launch.build(cfg, tcfg, ocfg, seed=0, device="cpu")
    params, opt, first = _run(step_fn, params, opt, stream(0), k)
    ck = Checkpointer(str(tmp_path))
    ck.save(k, {"params": params, "opt": opt})
    ck.wait()
    _, fresh_p, fresh_o, step_fn = launch.build(cfg, tcfg, ocfg, seed=5, device="cpu")
    start, state = ck.restore_latest({"params": fresh_p, "opt": fresh_o})
    assert start == k and state["opt"]["adam"]["step"] == k
    got_p, got_o, rest = _run(step_fn, state["params"], state["opt"], stream(start), n,
                              start=start)
    assert got_o["adam"]["step"] == want_o["adam"]["step"] == n
    for a, b in zip(leaves(got_p) + leaves(got_o["adam"]["m"]) + leaves(got_o["adam"]["v"]),
                    leaves(want_p) + leaves(want_o["adam"]["m"]) + leaves(want_o["adam"]["v"])):
        assert torch.equal(a, b)
    key = lambda r: (r["step"], r["loss"], r["lr"], r["grad_norm"])   # noqa: E731
    assert [key(r) for r in first + rest] == [key(r) for r in want_r]


def test_cli_resume_records_equal_uninterrupted(tmp_path, monkeypatch):
    monkeypatch.setattr(launch, "TrainConfig", functools.partial(TrainConfig, checkpoint_every=2))
    argv = ["--arch", "minicpm-2b", "--smoke", "--seq", "32", "--batch", "2", "--device", "cpu",
            "--log-every", "1"]
    ck = ["--ckpt", str(tmp_path / "ck")]
    first = launch.main(argv + ck + ["--steps", "4"])
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [2, 4]
    resumed = launch.main(argv + ck + ["--steps", "6"])
    whole = launch.main(argv + ["--steps", "6"])
    key = lambda r: (r["step"], r["loss"], r["lr"], r["grad_norm"])   # noqa: E731
    assert [r["step"] for r in resumed] == [5, 6]
    assert [key(r) for r in first + resumed] == [key(r) for r in whole]
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [2, 4, 6]


def test_mesh_still_refused():
    # a mesh of more than one rank runs only under torchrun; outside it, refused
    with pytest.raises(RuntimeError, match="mesh 2x1 .* torchrun"):
        launch.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--mesh", "2x1"])
