"""Multi-pod dry-run: plan every (arch x shape x mesh) cell without a card
(port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 256 / 512 placeholder
devices and reads XLA's memory and cost analysis.  Here nothing is
compiled and nothing is allocated: the port's own step runs once a
cell on ``meta`` tensors (``launch/specs.py``), on an ``AbstractMesh``
of the production shape (``launch/mesh.py``), whose collectives only
log what they would move (``collectives.log``), under :class:`StepTrace`,
which counts FLOPs, HBM bytes and the live tensors op by op.  Importing
this module sets nothing: no environment variable, no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

What a record counts, per rank:
  * ``memory.argument_gb``: the argument trees' bytes under the port's
    sharding rules (``sharding.params_shardings`` by profile,
    ``batch_pspec``, ``cache_pspec``), as the reference's
    ``shardings_for``; XLA's ``argument_size_in_bytes``.
  * ``memory.peak_per_device_gb``: the state the port's step holds plus
    ``temp_gb``, the largest sum of tensors alive at once in the trace on
    top of it: for a train step the params tree gathered in the compute
    dtype (``runtime/train_loop.py``'s ``_sharded_step``), the gradients
    and their local copies, the live activations of one microbatch.  A
    decode step holds its rows of the cache whole (attention runs
    replicated over the model axis), not the ``cache_pspec`` block.
    ``fits_80gb``: that peak within one H100's 80 GB.
  * ``roofline``: FLOPs and bytes of the trace, with every region a
    Hopper kernel computes on the card charged at the kernel's own count
    (its package's ``ops.cost``, which ``chip_smoke.py``'s bounds also
    read: each input read once, each output written once, the pairs a
    mask keeps), never what the plain version does; the collectives' records through the ring models
    of ``core/roofline.py``.  Everything else is the eager op's inputs read
    and outputs written, as the port runs them (no fusion).  Dense and SSM
    compute are replicated over the model axis and the experts split over
    it (``moe.apply_sharded``), so a dense model's per-rank FLOPs are its
    global FLOPs over the data size: ``useful_flops_ratio`` shows it.
  * A serving rank holds the params whole: on a mesh of more than one
    rank it gathers the blocks it keeps once, before its steps, as the
    port's decode on a mesh does (``tests/test_torch_distributed.py``), so
    a serving step issues no collective.  ``launch/serve.py`` itself takes
    no mesh.
  * An op's bytes: its inputs read (at most each one's storage) and its
    outputs written; a gather (indexing, an embedding lookup) reads only
    the rows it returns, an in-place scatter writes only the rows given.

Layers of one kind are traced at one and two layer groups and the terms
extrapolated to the arch's depth (the reference's ``extrapolated_roofline``
does the same for its scan); a train step is traced at one and two
microbatches and extrapolated to the cell's count.  ``trace_s`` replaces
the reference's ``lower_s`` / ``compile_s``.  ``cpu_bf16_inflation_gb``
and ``peak_tpu_adjusted_gb`` corrected XLA:CPU buffers and have no
counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import json
import os
import pkgutil
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import collectives
from repro_torch import sharding as shd
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.core import roofline as rl
from repro_torch.kernels import cost as C
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.specs import (META, batch_specs, cache_leaves, cached_params,
                                      default_tcfg, input_specs)
from repro_torch.models.transformer import Model
from repro_torch.tree import map_tree

# ops that move no bytes (allocation, metadata)
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default, torch.ops.aten.detach.default,
         torch.ops.aten.lift_fresh.default, torch.ops.aten.set_.source_Storage_storage_offset,
         torch.ops.aten._unsafe_view.default}
# gathers read only the rows they return (and their indices)
_GATHERS = {torch.ops.aten.index.Tensor, torch.ops.aten.index_select.default,
            torch.ops.aten.embedding.default, torch.ops.aten.gather.default}
# in-place scatters write only the rows they are given (and read their indices)
_SCATTERS = {torch.ops.aten.index_put_.default, torch.ops.aten.index_add_.default,
             torch.ops.aten.scatter_.src, torch.ops.aten.scatter_add_.default}


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements, at most its storage (an
    expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepTrace(TorchDispatchMode):
    """Counts a traced step op by op: FLOPs by operand type (the ops
    ``torch.utils.flop_counter`` knows: matmuls, convolutions), the bytes
    each op reads and writes, and the bytes of tensors alive at once
    (storages made inside the trace, freed when their last user goes).
    Kernel regions :meth:`charge` their own counts instead."""

    def __init__(self):
        super().__init__()
        self.flops = {}
        self.bytes = 0
        self.launches = {}
        self.live = 0
        self.peak = 0
        self._held = set()

    def _free(self, key, nbytes):
        self._held.discard(key)
        self.live -= nbytes

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            self._held.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.live)

    def charge(self, name: str, flops: dict, nbytes: int) -> None:
        """One launch of kernel ``name``: its FLOPs by type and bytes."""
        for k, v in flops.items():
            self.flops[k] = self.flops.get(k, 0) + v
        self.bytes += nbytes
        self.launches[name] = self.launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        if func in _FREE or _is_view(func):
            return out
        ins = _tensors((args, kwargs))
        packet = func._overloadpacket
        if packet in flop_registry:
            k = C.op_type(ins[0].dtype)
            self.flops[k] = self.flops.get(k, 0) + flop_registry[packet](
                *args, **kwargs, out_val=out)
        if func in _GATHERS:
            moved = sum(_read_bytes(t) for t in ins[1:]) + 2 * C.nbytes(*_tensors(out))
        elif func in _SCATTERS:
            moved = sum(_read_bytes(t) for t in ins[1:]) + _read_bytes(ins[-1])
        else:
            moved = sum(_read_bytes(t) for t in ins) + C.nbytes(*_tensors(out))
        self.bytes += moved
        return out


# --- kernel regions: each kernel's own count (``kernels/cost.py``) -----------------

def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _flash_bwd_out(q, k, v, o, lse, do, **kw):
    delta = torch.empty_like(lse)   # 7c's D_i, alive until 7b has read it
    del delta
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _decode_out(q, *args, **kw):
    b, hq, _, d = q.shape
    return _empty((b, hq, 1, d), torch.float32, q)


def _ssd_out(x, dt, a, b, c, *, chunk=128, save_states=False, fault=0):
    y = torch.empty_like(x, dtype=torch.float32)
    if not save_states:
        return y
    bsz, l, h, p = x.shape
    nc = -(-l // min(chunk, l))
    return y, _empty((bsz, h, nc, p, b.shape[3]), torch.float32, x)


def _ssd_bwd_out(x, dt, a, b, c, h0s, dy, **kw):
    dhs = torch.empty_like(h0s)     # 8b's, alive until 8c has read it
    del dhs
    return tuple(torch.empty_like(t, dtype=torch.float32) for t in (x, dt, a, b, c))


def _matmul_out(default):
    def out(x, w, scale_x, scale_w, out_dtype=default):
        return _empty((x.shape[0], w.shape[-1]), out_dtype, x)
    return out


# what each priced wrapper returns: tensors of its kernel's shapes and dtypes
_OUTPUTS = {
    "flash_attention": lambda q, k, v, **kw: (torch.empty_like(q),
                                              _empty(q.shape[:3], torch.float32, q)),
    "flash_attention_bwd": _flash_bwd_out,
    "flash_attention_masked": lambda q, *args, **kw: torch.empty_like(q),
    "paged_attention_kernel": _decode_out,
    "ring_decode_kernel": _decode_out,
    "ssd_scan": _ssd_out,
    "ssd_scan_bwd": _ssd_bwd_out,
    "ssd_prefill": lambda x, dt, a, b, c, h_init, **kw: (
        torch.empty_like(x, dtype=torch.float32), torch.empty_like(h_init)),
    "ent_matmul_packed_fused": _matmul_out(torch.float32),
    "ent_matmul_packed": _matmul_out(torch.float32),
    "ent_matmul": _matmul_out(torch.float32),
    "int8_matmul": _matmul_out(torch.bfloat16),
}


def priced():
    """(ops module, wrapper name) of every wrapper a kernel package prices
    (its ``ops.COSTED``)."""
    from repro_torch import kernels
    out = []
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.ispkg:
            mod = importlib.import_module(f"repro_torch.kernels.{info.name}.ops")
            out += [(mod, name) for name in getattr(mod, "COSTED", ())]
    return out


def _region(trace, mod, name, *args, **kwargs):
    """A priced wrapper's call on ``meta``: its launches charged at their
    own counts, its outputs made empty."""
    for kernel, flops, nbytes in mod.cost(name, *args, **kwargs):
        trace.charge(kernel, flops, nbytes)
    return _OUTPUTS[name](*args, **kwargs)


@contextlib.contextmanager
def traced(trace: StepTrace):
    """Run under ``trace`` with every priced kernel wrapper (:func:`priced`)
    replaced by its charge, and the collectives logging into
    ``trace.collectives``."""
    saved = []
    prev_log, collectives.log = collectives.log, []
    try:
        for mod, name in priced():
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, functools.partial(_region, trace, mod, name))
        with trace:
            yield trace
    finally:
        trace.collectives = collectives.log
        collectives.log = prev_log
        for mod, name, real in saved:
            setattr(mod, name, real)


# --- shardings and argument bytes -------------------------------------------------

def shardings_for(kind, args, mesh, profile="2d"):
    """Spec trees matching the (params, ...) argument tuple; a decode
    cache's as {path: spec} over :func:`specs.cache_leaves`."""
    if kind == "train":
        params, opt_state, batch = args
        pspec = shd.params_shardings(params, mesh, profile)
        ospec = {"adam": {
            "m": shd.params_shardings(opt_state["adam"]["m"], mesh, profile),
            "v": shd.params_shardings(opt_state["adam"]["v"], mesh, profile),
            "step": shd.replicated(mesh),
        }}
        return (pspec, ospec, {k: shd.batch_pspec(v.shape, mesh) for k, v in batch.items()})
    if kind == "prefill":
        params, batch = args
        return (shd.params_shardings(params, mesh, profile),
                {k: shd.batch_pspec(v.shape, mesh) for k, v in batch.items()})
    params, cache, tok = args
    return (shd.params_shardings(params, mesh, profile),
            {p: shd.cache_pspec(p, t.shape, mesh) for p, t in cache_leaves(cache)},
            shd.batch_pspec(tok.shape, mesh))


def local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of ``t``'s block on one rank under ``spec``."""
    n = 1
    for entry in spec:
        n *= shd._axis_size(mesh, entry)
    return t.numel() * t.element_size() // n


def _tree_bytes(tree, specs, mesh) -> int:
    out = []
    map_tree(lambda t, s: out.append(local_bytes(t, s, mesh)), tree, specs)
    return sum(out)


def argument_parts(kind, args, mesh, profile="2d") -> dict:
    """Per-rank bytes of a cell's arguments under the port's rules, by
    part: params, m, v, step (train), batch (train, prefill), cache,
    tokens (decode)."""
    sh = shardings_for(kind, args, mesh, profile)
    out = {"params": _tree_bytes(args[0], sh[0], mesh)}
    if kind == "train":
        a, s = args[1]["adam"], sh[1]["adam"]
        out.update(m=_tree_bytes(a["m"], s["m"], mesh), v=_tree_bytes(a["v"], s["v"], mesh),
                   step=local_bytes(a["step"], s["step"], mesh))
    if kind == "decode":
        out["cache"] = sum(local_bytes(t, sh[1][p], mesh) for p, t in cache_leaves(args[1]))
        out["tokens"] = local_bytes(args[2], sh[2], mesh)
    else:
        out["batch"] = _tree_bytes(args[-1], sh[-1], mesh)
    return out


def argument_bytes(kind, args, mesh, profile="2d") -> int:
    """Per-rank bytes of a cell's arguments (XLA's ``argument_size_in_bytes``)."""
    return sum(argument_parts(kind, args, mesh, profile).values())


# --- one rank's step on meta ---------------------------------------------------------

def _act_spec(mesh, profile):
    da = shd.data_axes(mesh)
    if profile == "fsdp":    # batch over every axis, activations local
        flat = (da + ("model",)) if isinstance(da, tuple) else (da, "model")
        return (flat, None, None)
    return (da, "model", None)       # Megatron seq parallelism


def _local_rows(rows: int, mesh) -> int:
    entry = shd.batch_pspec((rows,), mesh)[0]
    return rows // shd._axis_size(mesh, entry)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def trace_step(kind, cfg, shape, mesh, *, profile="2d", tcfg=None, ocfg=None,
               quantized=False, kv_quant=False, moe_rank_major=False) -> dict:
    """One rank's step of ``cfg`` as it stands (its depth; a train step's
    ``tcfg.global_batch`` over its microbatches) on ``meta``: {"flops/<type>",
    "launches/<kernel>", "bytes", "temp" (the most bytes alive at once
    on top of the state), "held" (the state the step holds), "output",
    "alias" (returned tensors new / updated in place)}, and "records":
    the collectives' (kind, result bytes, group ranks)."""
    from repro_torch.configs.base import OptimConfig
    from repro_torch.models import layers as L
    from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step
    from repro_torch.runtime.train_loop import make_train_step

    da = shd.data_axes(mesh)
    model = Model(cfg, device=META, kv_quant=kv_quant, dist=(mesh, da))
    text = cfg.modality == "text"
    cdt = L.cdtype(cfg)
    if kind == "train":
        full = cached_params(cfg, False, False)
        specs = shd.params_shardings(full, mesh, profile)
        local = shd.local_shard_tree(full, specs, mesh)
        opt = {"adam": {k: map_tree(lambda t: t.to(torch.float32).clone(), local)
                        for k in ("m", "v")}}
        opt["adam"]["step"] = 0
        rows = _local_rows(tcfg.global_batch, mesh)
        batch = {k: _meta((rows,) + tuple(v.shape[1:]), v.dtype) for k, v in batch_specs(
            cfg, dataclasses.replace(shape, global_batch=tcfg.global_batch)).items()}
        step = make_train_step(model, ocfg or OptimConfig(), tcfg, data_axes=da,
                               grad_shardings=specs)
        args = (local, opt, batch)
        held = _nbytes(args)
    else:
        full = cached_params(cfg, True, quantized)
        if moe_rank_major and cfg.moe is not None:
            from repro_torch.models.moe import rank_major_params
            full = rank_major_params(full, mesh.shape["model"])
        specs = shd.params_shardings(full, mesh, profile)
        # a rank serves from the params whole: on a mesh it gathers its kept
        # blocks once, before its steps (nothing a step), as the port's decode
        # on a mesh does, and lets the blocks go
        whole = shd.gather_tree(shd.local_shard_tree(full, specs, mesh), specs, mesh)
        rows = _local_rows(shape.global_batch, mesh)
        if kind == "prefill":
            base = make_prefill_step(model)
            rest = ({"tokens": _meta((rows, shape.seq_len), torch.int32)} if text else
                    {"embeds": _meta((rows, shape.seq_len, cfg.d_model), cdt)},)
            held = _nbytes((whole, rest))
        else:
            cache = model.init_cache(rows, shape.seq_len, kind=cfg.cache_kind)
            # every slot at the cache's last row (the token that reads it whole), a
            # position a slot, as the serving engine keeps them
            cache["pos"] = torch.full((rows,), shape.seq_len - 1, dtype=torch.int32,
                                      device=META)
            if text:
                base = make_serve_step(model)
                rest = (cache, _meta((rows,), torch.int32))
            else:
                def base(params, cache, embeds):
                    return model.decode_step(params, cache, embeds=embeds)
                rest = (cache, _meta((rows, 1, cfg.d_model), cdt))
            held = _nbytes((whole, [t for _, t in cache_leaves(cache)], rest[1]))

        def step(*args):
            with torch.no_grad():
                return base(*args)

        args = (whole,) + rest
    trace = StepTrace()
    with traced(trace):
        out = step(*args)
    ins = {t.untyped_storage()._cdata for t in _tensors(args)}
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in _tensors(out)}
    rec = {f"flops/{k}": float(v) for k, v in trace.flops.items()}
    rec.update({f"launches/{k}": float(v) for k, v in trace.launches.items()})
    rec.update(bytes=float(trace.bytes), temp=float(trace.peak), held=float(held),
               output=float(sum(v for k, v in outs.items() if k not in ins)),
               alias=float(sum(v for k, v in outs.items() if k in ins)),
               records=trace.collectives)
    return rec


def _counts(rec: dict) -> dict:
    """A trace's numbers, its collectives folded by (kind, group)."""
    out = {k: v for k, v in rec.items() if k != "records"}
    for kind, nbytes, ranks in rec["records"]:
        key = f"coll/{kind}/{','.join(map(str, ranks))}"
        out[key] = out.get(key, 0.0) + nbytes
        out["count/" + key] = out.get("count/" + key, 0.0) + 1
    return out


def _extrapolate(a: dict, b: dict, times: float) -> dict:
    """a + times * (b - a) key by key (a key missing counts 0), clamped at
    no decrease, as the reference's depth extrapolation."""
    return {k: a.get(k, 0.0) + times * max(b.get(k, 0.0) - a.get(k, 0.0), 0.0)
            for k in set(a) | set(b)}


def plan_cell(kind, cfg, shape, mesh, *, tcfg=None, **kw) -> dict:
    """The cell's per-rank counts at full depth (``trace_step``'s keys, the
    collectives as "coll/<kind>/<ranks>" bytes and "count/..." calls):
    traces at one and two layer groups and, for a train step, at one and
    two microbatches, extrapolated linearly.  Memory ("temp", "held",
    "output", "alias") is one microbatch's."""
    glen = len(cfg.group)

    def at(depth, t=None):
        c = dataclasses.replace(cfg, num_layers=depth * glen)
        return _counts(trace_step(kind, c, shape, mesh, tcfg=t, **kw))

    g = cfg.num_groups
    if kind != "train":
        return _extrapolate(at(1), at(2), g - 1)
    tcfg = tcfg or default_tcfg(cfg, shape)
    mb = tcfg.microbatch or tcfg.global_batch
    t1, t2 = (dataclasses.replace(tcfg, global_batch=k * mb, microbatch=mb) for k in (1, 2))
    one = _extrapolate(at(1, t1), at(2, t1), g - 1)
    two = _extrapolate(at(1, t2), at(2, t2), g - 1)
    out = _extrapolate(one, two, tcfg.global_batch // mb - 1)
    for k in ("temp", "held", "output", "alias"):
        out[k] = one[k]
    return out


def roofline_of(counts: dict, peak_bytes: float) -> rl.Roofline:
    flops = {k.split("/", 1)[1]: v for k, v in counts.items() if k.startswith("flops/")}
    records = []
    for k, v in counts.items():
        if k.startswith("coll/"):
            _, kind, ranks = k.split("/")
            records.append((kind, v, tuple(int(r) for r in ranks.split(","))))
    coll = rl.collective_bytes(records)
    coll["counts"] = {kind: int(round(sum(v for k, v in counts.items()
                                          if k.startswith(f"count/coll/{kind}/"))))
                      for kind in rl._COLLECTIVES}
    return rl.Roofline(flops=sum(flops.values()), hbm_bytes=counts.get("bytes", 0.0),
                       coll_bytes=coll["total"], coll_detail=coll,
                       peak_memory_bytes=peak_bytes, flops_by_type=flops,
                       coll_cross_bytes=coll["cross_node"])


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             verbose: bool = True, tcfg=None, profile: str = "2d", cfg_transform=None,
             quantized=False, kv_quant=False, moe_rank_major=False, mesh=None, cfg=None):
    """One cell's record (the reference's keys; see the module docstring).
    ``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``; ``mesh``: an
    ``AbstractMesh`` instead of the production one; ``cfg`` instead of the
    registry's.  The roofline terms come from the same trace as the peak,
    so every record has them (the reference's ``roofline=False`` has no
    counterpart)."""
    cfg = cfg or get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    shape_name = shape.name
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    if shape_name == "long_500k" and not cfg.is_sub_quadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "pure full-attention arch; long_500k needs "
                          "sub-quadratic attention (DESIGN.md)"}
    mesh = mesh or abstract_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    dist = (mesh, shd.data_axes(mesh))
    _, args, kind = input_specs(arch, shape, cfg=cfg, tcfg=tcfg, dist=dist,
                                act_sharding=_act_spec(mesh, profile), quantized=quantized,
                                kv_quant=kv_quant, moe_rank_major=moe_rank_major,
                                profile=profile)
    arg_bytes = argument_bytes(kind, args, mesh, profile)
    del args
    counts = plan_cell(kind, cfg, shape, mesh, profile=profile, tcfg=tcfg,
                       quantized=quantized, kv_quant=kv_quant, moe_rank_major=moe_rank_major)
    t_trace = time.perf_counter() - t0
    peak = counts["held"] + counts["temp"]
    roof = roofline_of(counts, peak)
    mf = rl.model_flops(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "profile": profile,
        "status": "ok",
        "kind": kind,
        "num_devices": mesh.size,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_gb": arg_bytes / 1e9,
            "output_gb": counts["output"] / 1e9,
            "temp_gb": counts["temp"] / 1e9,
            "alias_gb": counts["alias"] / 1e9,
            "peak_per_device_gb": peak / 1e9,
            "fits_80gb": peak <= rl.CARD_BYTES,
        },
        "roofline": roof.as_dict(),
        "model_flops_global": mf,
        "model_flops_per_dev": mf / mesh.size,
        "useful_flops_ratio": (mf / mesh.size) / max(roof.flops, 1.0),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {rec['mesh']}] trace {t_trace:.1f}s  "
              f"peak/dev {rec['memory']['peak_per_device_gb']:.2f} GB "
              f"(fits 80 GB: {rec['memory']['fits_80gb']}) "
              f"compute {roof.compute_s*1e3:.2f}ms "
              f"memory {roof.memory_s*1e3:.2f}ms "
              f"collective {roof.collective_s*1e3:.2f}ms "
              f"-> {roof.bottleneck}")
        print(f"  arguments {rec['memory']['argument_gb']:.2f} GB, held + "
              f"temp {rec['memory']['temp_gb']:.2f} GB (per rank); "
              f"{roof.flops:.3e} flops/dev, {roof.hbm_bytes:.3e} HBM bytes/dev, "
              f"{roof.coll_bytes:.3e} collective bytes/dev")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}_{shape}_{'mp' if mp else 'sp'}"
        path = os.path.join(args.out, tag + ".json")
        try:
            rec = run_cell(arch, shape, multi_pod=mp)
        except Exception as e:  # a failing cell is a bug in the port
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "mesh": "multi_pod" if mp else "single_pod",
                   "status": "failed", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
