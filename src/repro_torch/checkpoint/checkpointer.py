"""Fault-tolerant checkpointing: atomic step dirs, async save, integrity
(port of ``repro/checkpoint/checkpointer.py``, same layout).

    <dir>/step_000000500/
        shard_00000.npz      # flat {index -> array} for this host's leaves
        manifest.json        # step, num_hosts, each leaf's shape and dtype,
                             # the shard's sha256
    <dir>/step_000000500.tmp/   # in-flight writes (never read)
    <dir>/LATEST             # text file with the newest complete step

A step dir is written as ``.tmp`` and renamed into place when complete;
``latest_step`` scans only complete dirs, and ``.tmp`` dirs left by a
crash are removed at start-up.  ``save`` snapshots every leaf to host
numpy at once (a copy, ``tensor.detach().to("cpu", copy=True)``, which
waits for the device), then writes on a background thread; ``wait()`` joins it before the next
save or at shutdown.

The files are the reference's: a checkpoint written by either package
restores in the other, bit for bit.  So that the manifest's leaf list
means the same in both, leaves are taken in JAX's flattening order: dict
keys sorted, sequences in order, ``None`` no leaf.  numpy has no
bfloat16: a bf16 tensor is stored as its raw 16-bit words (``V2``, as
numpy stores the reference's ``ml_dtypes`` leaves) with the dtype string
``"bfloat16"``, and comes back as ``torch.bfloat16`` on the device of
the like-tree's leaf.  A Python ``int`` leaf (the AdamW step counter) is
stored as an int32 scalar, as the reference's step, and comes back as an
``int``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["Checkpointer", "flatten"]


def flatten(tree) -> list:
    """Leaves in JAX's ``tree_flatten`` order: dict keys sorted, lists and
    tuples in order, ``None`` holding no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    if tree is None:
        return []
    return [tree]


def _unflatten(like, it):
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    if like is None:
        return None
    return next(it)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (bf16 as its raw words,
    ``V2``): a copy even of a CPU tensor, which a later in-place step would
    change under the background write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like):
    """A stored array as a leaf of ``like``'s kind: a tensor on ``like``'s
    device, an ``int``, else the array itself."""
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(like.device)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    return arr


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            digest.update(blk)
    return digest.hexdigest()


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_index: int = 0, num_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host = host_index
        self.num_hosts = num_hosts
        self._thread: threading.Thread | None = None
        # the last save's {"step", "bytes", "snapshot_s", "write_s"}
        # (write_s once its write has finished)
        self.last_save: dict = {}
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # -- paths --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _shard(self) -> str:
        return f"shard_{self.host:05d}"

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- save --
    def save(self, step: int, tree, *, blocking: bool = False):
        """Snapshot now (device -> host copy), write in the background."""
        self.wait()
        t0 = time.perf_counter()
        leaves = flatten(tree)
        arrays = [_to_host(x) for x in leaves]
        dtypes = [_dtype_name(x, a) for x, a in zip(leaves, arrays)]
        stats = {"step": step, "bytes": sum(a.nbytes for a in arrays),
                 "snapshot_s": time.perf_counter() - t0}
        self.last_save = stats

        def write():
            t1 = time.perf_counter()
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            shard_path = os.path.join(tmp, self._shard() + ".npz")
            np.savez(shard_path, **{str(i): a for i, a in enumerate(arrays)})
            manifest = {
                "step": step,
                "num_hosts": self.num_hosts,
                "leaves": [{"shape": list(a.shape), "dtype": d}
                           for a, d in zip(arrays, dtypes)],
                "checksum": {self._shard(): _sha256(shard_path)},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                   # atomic completion
            with open(os.path.join(self.dir, "LATEST"), "w") as f:
                f.write(str(step))
            self._gc_old()
            stats["write_s"] = time.perf_counter() - t1

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc_old(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, *, verify: bool = True):
        """Load a step into the structure of ``like_tree``: each tensor leaf
        onto its like-leaf's device, in the stored dtype."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        shard_path = os.path.join(d, self._shard() + ".npz")
        if verify and _sha256(shard_path) != manifest["checksum"][self._shard()]:
            raise IOError(f"checkpoint shard corrupt at step {step}")
        like = flatten(like_tree)
        if len(like) != len(manifest["leaves"]):
            raise ValueError("checkpoint tree structure mismatch")
        loaded = []
        with np.load(shard_path) as data:
            for i, want in enumerate(like):
                a = data[str(i)]
                shape = tuple(getattr(want, "shape", ()))
                if tuple(a.shape) != shape:
                    raise ValueError(f"shape mismatch {a.shape} vs {shape}")
                loaded.append(_from_host(a, manifest["leaves"][i]["dtype"], want))
        return _unflatten(like_tree, iter(loaded))

    def restore_latest(self, like_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like_tree)
