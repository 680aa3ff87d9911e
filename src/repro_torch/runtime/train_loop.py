"""Training step factory (port of ``repro/runtime/train_loop.py``): loss
-> grads -> AdamW, with microbatch accumulation, the remat policy and
optional int8 gradient compression with error feedback.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``.  The float params are the float32 master
weights; inside the loss they are cast to the compute dtype, so the
gradients flow back in float32 through the casts, as in the reference.
The step updates params and optimizer state in place (see
``optim.adamw.update``).  The reference's ``grad_prepin`` is a sharding
hint and changes nothing on one card.
"""

from __future__ import annotations

from repro_torch.configs.base import OptimConfig, TrainConfig
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


def make_train_step(model: Model, ocfg: OptimConfig, tcfg: TrainConfig):
    gdt = None if tcfg.grad_dtype == "float32" else L._DTYPES[tcfg.grad_dtype]
    loss_of = make_loss(model, tcfg.remat)

    def train_step(params, opt_state, batch):
        """``batch``: {"tokens", "labels"} [B, S] integer tensors on the
        model's device."""
        micro = [batch]
        if tcfg.microbatch and tcfg.microbatch > 0:
            rows, mb = batch["tokens"].shape[0], tcfg.microbatch
            if rows % mb:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"microbatches of {mb}")
            micro = [{k: v[i:i + mb] for k, v in batch.items()}
                     for i in range(0, rows, mb)]
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


def init_opt_state(tcfg: TrainConfig, params):
    state = {"adam": adamw.init(params)}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = gradlib.ef_init(params)
    return state
