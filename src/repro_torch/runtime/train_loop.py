"""Training step factory (port of ``repro/runtime/train_loop.py``): loss
-> grads -> AdamW, with microbatch accumulation, the remat policy and
optional int8 gradient compression with error feedback.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``.  The float params are the float32 master
weights; inside the loss they are cast to the compute dtype, so the
gradients flow back in float32 through the casts, as in the reference.
The step updates params and optimizer state in place (see
``optim.adamw.update``).  The reference's ``grad_prepin`` is a sharding
hint and changes no number.

On a mesh (``data_axes`` given; the model built with ``dist=(mesh,
data_axes)``): params, ``m`` and ``v`` (and ``ef`` under ``int8_ef``)
are this rank's shards by ``grad_shardings`` (``sharding.params_shardings``
of the full params, profile ``"2d"``), so storage scales 1 / n; the
batch is this rank's rows (``sharding.batch_pspec``).  The step casts
the shards to the compute dtype and gathers them (as the reference casts
before its FSDP gathers), runs the loss and its gradient on the rank's
rows with microbatches as on one device (``tcfg.microbatch`` counts
global rows: each rank takes its share of every microbatch), sums each
gradient over the data axes (and over the model axis too for the expert
stacks, whose ranks each hold part: ``moe.apply_sharded``) and divides
by the data axes' size, takes the norm of the whole gradient (the same
on every rank), and runs AdamW on the local shards, clipped by that
norm.  Nothing else is summed over the model axis: its ranks hold the
same rows and compute the same dense and SSM layers.  ``loss`` is
averaged over the data axes.  The gradient lives whole for the length
of the step; a gather layer by layer would cut that peak.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import collectives, sharding, tracing
from repro_torch.configs.base import OptimConfig, TrainConfig
from repro_torch.launch.mesh import axes_of
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.optim import adamw, grad as gradlib
from repro_torch.tree import map_tree


def make_loss(model: Model, remat: str = "none"):
    """``loss_of(params, batch)``: the scalar training loss, with the float
    params cast to the compute dtype inside it."""
    cdt = L.cdtype(model.cfg)

    def loss_of(params, batch):
        pc = map_tree(lambda a: a.to(cdt) if a.is_floating_point() else a, params)
        return loss_fn(model, pc, batch, remat=remat)[0]

    return loss_of


def _microbatches(batch, mb: int):
    if not mb:
        return [batch]
    rows = batch["labels"].shape[0]
    if rows % mb:
        raise ValueError(f"batch of {rows} rows does not split into microbatches of {mb}")
    return [{k: v[i:i + mb] for k, v in batch.items()} for i in range(0, rows, mb)]


def _expert_stack(path: str, t) -> bool:
    """An MoE expert stack [E, i, o], which ``apply_sharded`` splits over the
    model axis."""
    parts = path.split("/")
    return (len(parts) >= 2 and parts[-2] == "ffn"
            and parts[-1] in ("wi", "wi_gate", "wi_up", "wo") and t.dim() == 3)


def _spanned(step):
    """``step`` inside the span ``train.step``."""
    @functools.wraps(step)
    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            return step(params, opt_state, batch)

    return train_step


def make_train_step(model: Model, ocfg: OptimConfig, tcfg: TrainConfig,
                    data_axes=None, grad_shardings=None):
    """``data_axes``: the mesh axes of the batch dim; with it the step is
    the sharded one (see the module docstring) and ``grad_shardings`` the
    params' spec tree."""
    gdt = None if tcfg.grad_dtype == "float32" else L._DTYPES[tcfg.grad_dtype]
    loss_of = make_loss(model, tcfg.remat)
    if data_axes is not None:
        return _sharded_step(model, ocfg, tcfg, data_axes, grad_shardings, gdt, loss_of)

    @_spanned
    def train_step(params, opt_state, batch):
        """``batch``: {"tokens", "labels"} [B, S] integer tensors on the
        model's device."""
        micro = _microbatches(batch, tcfg.microbatch)
        loss, grads = gradlib.accumulate(loss_of, params, micro, grad_dtype=gdt)
        if tcfg.grad_compression == "int8_ef":
            grads, new_ef = gradlib.compress_int8(grads, opt_state["ef"],
                                                  len(model.cfg.group))
        params, inner, metrics = adamw.update(ocfg, grads, opt_state["adam"], params)
        new_state = {"adam": inner}
        if tcfg.grad_compression == "int8_ef":
            new_state["ef"] = new_ef
        return params, new_state, dict(metrics, loss=loss)

    return train_step


def _sharded_step(model, ocfg, tcfg, data_axes, specs, gdt, loss_of):
    if model.dist is None or specs is None:
        raise ValueError("a sharded train step needs a model built with dist=(mesh, "
                         "data_axes) and grad_shardings, the params' spec tree")
    mesh = model.dist[0]
    cdt = L.cdtype(model.cfg)
    nd = mesh.axis_size(data_axes)
    split = sharding.batch_pspec((tcfg.global_batch,), mesh)[0] is not None
    mb = tcfg.microbatch or 0
    if split and mb % nd:
        raise ValueError(f"microbatch {mb} does not split over {nd} data shards")
    local_mb = mb // nd if split else mb
    experts = axes_of(data_axes) + ("model",)

    @_spanned
    def train_step(params, opt_state, batch):
        """``params`` and ``opt_state``: this rank's shards; ``batch``: this
        rank's rows, {"tokens" (or "embeds"), "labels"} [B_loc, S]."""
        rows = batch["labels"].shape[0]
        want = tcfg.global_batch // nd if split else tcfg.global_batch
        if rows != want:
            raise ValueError(f"{rows} rows on this rank; a global batch of "
                             f"{tcfg.global_batch} over {nd} data shards gives {want}")
        with torch.no_grad():
            full = sharding.gather_tree(
                map_tree(lambda a: a.to(cdt) if a.is_floating_point() else a, params),
                specs, mesh)
        loss, grads = gradlib.accumulate(loss_of, full, _microbatches(batch, local_mb),
                                         grad_dtype=gdt)
        del full
        with torch.no_grad():
            for path, g in sharding.tree_paths(grads):
                collectives.all_reduce(g, mesh, experts if _expert_stack(path, g)
                                       else data_axes)
                if nd > 1:
                    g.div_(nd)
            collectives.all_reduce(loss, mesh, data_axes)
            if nd > 1:
                loss = loss / nd
            new_state = {}
            if tcfg.grad_compression == "int8_ef":
                ef = sharding.gather_tree(opt_state["ef"], specs, mesh)
                grads, res = gradlib.compress_int8(grads, ef, len(model.cfg.group))
                del ef
                new_state["ef"] = sharding.local_shard_tree(res, specs, mesh)
            norm = adamw.global_norm(grads)
            local = sharding.local_shard_tree(grads, specs, mesh)
            del grads
        params, inner, metrics = adamw.update(ocfg, local, opt_state["adam"], params,
                                              norm=norm)
        new_state = {"adam": inner, **new_state}
        return params, new_state, dict(metrics, loss=loss)

    train_step.specs = specs      # the params' spec tree (checkpoints gather by it)
    return train_step


def init_opt_state(tcfg: TrainConfig, params):
    state = {"adam": adamw.init(params)}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = gradlib.ef_init(params)
    return state
