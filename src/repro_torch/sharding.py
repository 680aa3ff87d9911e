"""Divisibility-aware sharding rules and the layouts they give (port of
``repro/sharding.py``).

Every parameter, cache and batch leaf gets a spec from path-based rules:
Megatron-style splits on the ``model`` axis, data parallelism on
``data`` (``("pod", "data")`` on the multi-pod mesh).  A central guard
drops any proposed mapping whose dimension the axis does not divide,
falling back to replication, so every (arch x mesh) pair has a layout
without per-arch tuning.

Conventions of the ``"2d"`` profile (model-axis split x FSDP on the data
axes; both dims of every big matrix are split, so params and AdamW
moments scale 1 / num_devices):
  column-parallel:  wq wk wv wi wi_gate wi_up in_proj  -> (data, model)
  row-parallel:     wo out_proj                        -> (model, data)
  experts [E,i,o]: EP on "model" when E | axis, FSDP on i -> (model, data, None)
                   else expert-internal TP              -> (None, data, model)
  embedding [V,D] -> (model, data);  lm_head [D,V] -> (data, model)
  norms, router, scalar vectors: replicated

A spec is a plain tuple with one entry per dim: ``None``, an axis name,
or a tuple of axis names (split major-to-minor in the order listed, as
``NamedSharding`` splits); ``()`` is replicated.  The port's params are
``layers/<i>/...`` with no leading ``[G]`` axis, so for a grouped leaf of
the reference the port's spec is the reference's without its leading
``None``.

:func:`local_shard` cuts a rank's block out of a full tensor and
:func:`gather` puts the blocks back together (``all_gather`` dim by
dim); the tree versions walk a state tree beside its spec tree.

How the port uses the layouts: training keeps params and moments as
local shards and gathers the params for the step
(``runtime/train_loop.py``); the MoE experts run expert-parallel on the
model axis (``models/moe.apply_sharded``).  Dense and SSM compute are
replicated over the model axis: the guard checks only that a flattened
dim divides, so a split can cut a head in two (qwen2.5-3b's wk is
[2048, 256], 2 kv heads of 128: over model 4 each rank would hold 64
columns, half a head).  GSPMD absorbs such a split in the reference; a
manual Megatron split cannot, so tensor-parallel compute is left to
later speed work.  The reference's ``shard_map_compat`` has no
counterpart (the port's ranks are processes), and neither have its
layout hints that change no number: ``act_sharding`` on the activations,
``row_sharding`` in the LM-head loss and ``grad_prepin``.
"""

from __future__ import annotations

import math

import torch

from repro_torch import collectives
from repro_torch.launch.mesh import axes_of
from repro_torch.tree import map_tree


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in axis)
    return mesh.shape[axis]


def _guard(spec_dims, shape, mesh) -> tuple:
    """Drop mappings whose dim doesn't divide the axis size."""
    out = []
    for dim, axis in zip(shape, spec_dims):
        if axis is not None and dim % _axis_size(mesh, axis) == 0 and dim > 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def data_axes(mesh):
    """The (possibly compound) data-parallel axis spec."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


_COL = ("wq", "wk", "wv", "wi", "wi_gate", "wi_up", "in_proj")
_ROW = ("wo", "out_proj")


def param_pspec(path: str, shape, mesh, profile: str = "2d") -> tuple:
    """Spec of one parameter given its tree path (``layers/3/mixer/wq/kernel``).

    Profiles:
      "2d"       model-axis split x FSDP on the data axes: the training default.
      "fsdp"     pure data parallel over ALL axes: kernels row-split over
                 (data + model), nothing on the model axis alone.
      "serve_tp" the model-axis split only, replicated over data: weights
                 stay in place on each rank, no per-step gathers (decode).
    """
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    shape = tuple(shape)

    # quantized records (quant/quantize.py): q / planes / scale sit under
    # the projection's name; q splits like the kernel, planes add a lead
    # [4] (or [2] packed) axis, scales follow the out-channel
    if name in ("q", "planes", "planes_packed") and parent in _COL + _ROW + ("lm_head",):
        extra = 0 if name == "q" else 1
        sub = param_pspec("/".join(parts[:-1]) + "/kernel", shape[extra:], mesh, profile)
        return _guard((None,) * extra + sub, shape, mesh)
    if name == "scale" and parent in _COL + _ROW + ("lm_head",):
        ker = param_pspec("/".join(parts[:-1]) + "/kernel", (1,) + shape[-1:], mesh, profile)
        return _guard((None, ker[-1]), shape, mesh)

    spec: tuple = (None,) * len(shape)
    da = data_axes(mesh)
    if profile == "fsdp":
        all_axes = (da + ("model",)) if isinstance(da, tuple) else (da, "model")
        if name == "embedding" or (name == "kernel" and len(shape) >= 2):
            spec = (all_axes,) + (None,) * (len(shape) - 1)
        elif parent == "ffn" and name in _COL + _ROW and len(shape) == 3:
            spec = (None, all_axes, None)
        return _guard(spec, shape, mesh)

    fs = None if profile == "serve_tp" else da   # FSDP axis (or stationary)

    if name == "embedding":                       # [V, D]
        spec = ("model", fs)
    elif parent == "lm_head" and name == "kernel":
        spec = (fs, "model")
    elif name == "kernel" and parent in _COL:
        spec = (fs, "model")
    elif name == "kernel" and parent in _ROW:
        spec = ("model", fs)
    elif name == "bias" and parent in _COL:
        spec = ("model",)
    elif parent == "ffn" and name in _COL and len(shape) == 3:
        # MoE experts [E, din, dout]: EP when E divides, else internal TP
        if shape[0] % _axis_size(mesh, "model") == 0:
            spec = ("model", fs, None)
        else:
            spec = (None, fs, "model")
    elif parent == "ffn" and name in _ROW and len(shape) == 3:
        if shape[0] % _axis_size(mesh, "model") == 0:
            spec = ("model", fs, None)
        else:
            spec = (None, "model", fs)
    # everything else (norm scales, biases of row-parallel layers, the
    # router, the SSM's conv / a_log / dt_bias / d_skip, ...) replicates
    return _guard(spec, shape, mesh)


def tree_paths(tree, prefix=""):
    """(path, leaf) pairs in :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def params_shardings(params, mesh, profile: str = "2d"):
    """Tree of specs for a params tree (tensors, or anything with ``.shape``).
    A spec is a tuple, so walk a spec tree beside a state tree
    (``tree.map_tree(fn, state, specs)``), not on its own."""
    return _map_paths(lambda path, leaf: param_pspec(path, leaf.shape, mesh, profile), params)


def batch_pspec(shape, mesh) -> tuple:
    """Token / label / embeds batches: the batch dim over the data axes if
    it divides."""
    spec = (data_axes(mesh),) + (None,) * (len(shape) - 1)
    return _guard(spec, shape, mesh)


def cache_pspec(path: str, shape, mesh) -> tuple:
    """A decode cache leaf of one layer (the reference's rule without its
    leading [G] axis):

    attn k/v (and int8 scales)  [B, W, Hkv, hd] -> batch on data; rows on model
    ssm  ssd                    [B, H, P, N]    -> batch on data; heads on model
    ssm  conv                   [B, W-1, C]     -> batch on data

    The port's decode keeps a rank's cache rows whole (attention runs
    replicated over the model axis), so the model-axis entries are the
    reference's storage layout, not one the port's decode reads."""
    name = path.split("/")[-1]
    da = data_axes(mesh)
    if name in ("k", "v", "k_s", "v_s") and len(shape) == 4:
        spec = (da, "model", None, None)
    elif name == "ssd" and len(shape) == 4:
        spec = (da, "model", None, None)
    elif name == "conv" and len(shape) == 3:
        spec = (da, None, None)
    elif name == "pos":
        spec = ()
    else:
        spec = (None,) * len(shape)
    return _guard(spec, shape, mesh)


def replicated(mesh) -> tuple:
    return ()


# --- layouts -----------------------------------------------------------------

def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``: a
    contiguous copy that holds none of ``t``'s storage."""
    for dim, entry in enumerate(spec):
        if axes_of(entry):
            n = mesh.axis_size(entry)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {entry}")
            t = t.narrow(dim, mesh.index(entry) * (t.shape[dim] // n), t.shape[dim] // n)
    return t.detach().clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local`` block under ``spec``."""
    for dim, entry in enumerate(spec):
        local = collectives.all_gather(local, mesh, entry, dim)
    return local


def local_shard_tree(tree, specs, mesh):
    """:func:`local_shard` leaf by leaf; a leaf that is no tensor (the AdamW
    step counter) passes through."""
    return map_tree(lambda t, s: local_shard(t, s, mesh) if isinstance(t, torch.Tensor) else t,
                    tree, specs)


def gather_tree(tree, specs, mesh):
    """:func:`gather` leaf by leaf, in the tree's leaf order on every rank."""
    return map_tree(lambda t, s: gather(t, s, mesh) if isinstance(t, torch.Tensor) else t,
                    tree, specs)
