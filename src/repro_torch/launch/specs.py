"""Shape-only stand-ins for every model input (port of
``repro/launch/specs.py``).

``input_specs(arch, shape)`` returns the (params, opt_state, batch) /
(params, batch) / (params, cache, tokens) trees of one benchmark cell
with every leaf a tensor on ``torch.device("meta")``: shapes and dtypes,
no storage, nothing allocated.  The reference builds them with
``jax.eval_shape``; here the port's own ``Model.init`` and
``init_cache`` run on ``meta`` (a CPU generator drawing for a model on
``meta`` makes shapes only).  The planner (``launch/dryrun.py``) reads
them.

The trees follow the port's layout (one dict a layer under
``"layers"``, one cache object a layer); ``opt_state["adam"]["step"]``
is an int32 scalar, as the reference's, where the port's step counts in
a Python int (a trace hands it 0).  The decode cache's ``"pos"`` is the
port's Python int, where the reference keeps an int32 scalar leaf.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import (ModelConfig, OptimConfig, QuantConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.tree import map_tree

META = torch.device("meta")
# the cache objects' tensors, in this order (absent ones are None or missing)
CACHE_FIELDS = ("k", "v", "k_s", "v_s", "block_table", "conv", "ssd")


def _cast_tree(tree, dtype):
    return map_tree(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _fresh(tree):
    """New leaf objects over the same (storage-free) tensors: a caller may
    set ``requires_grad`` or edit the dicts without touching a cached tree."""
    return map_tree(lambda t: t.detach(), tree)


@functools.lru_cache(maxsize=16)
def cached_params(cfg: ModelConfig, serving: bool, quantized: bool):
    """``cfg``'s params on ``meta``, made once a (config, kind): float in
    ``cfg.param_dtype``, or (``serving``) in the compute dtype, or the w8a8
    records.  Shared: take a copy (``_fresh``) before touching it."""
    params = Model(cfg, device=META).init(torch.Generator())
    if serving:
        params = _cast_tree(params, L.cdtype(cfg))
    if quantized:   # the same records for every serving shape: made once a config
        from repro_torch.quant.quantize import quantize_params
        params = quantize_params(params, QuantConfig(enabled=True, ent_encode=False))
    return params


def abstract_params(cfg: ModelConfig):
    """The params tree of ``cfg`` on ``meta``, in ``cfg.param_dtype``."""
    return _fresh(cached_params(cfg, False, False))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    specs = {"labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.modality == "text":
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
    else:
        specs["embeds"] = torch.empty((b, s, cfg.d_model), dtype=L.cdtype(cfg), device=META)
    return specs


def default_tcfg(cfg: ModelConfig, shape: ShapeConfig) -> TrainConfig:
    """remat "full" and microbatching, the production memory setting: 8
    microbatches above 6e10 params, 4 below."""
    n_micro = 8 if cfg.param_count() > 6e10 else 4
    return TrainConfig(seq_len=shape.seq_len, global_batch=shape.global_batch,
                       microbatch=max(shape.global_batch // n_micro, 1), remat="full")


def cache_leaves(cache) -> list:
    """(path, tensor) of a decode cache's tensors, ``layers/<i>/<field>``:
    the paths ``sharding.cache_pspec`` reads."""
    out = []
    for i, c in enumerate(cache["layers"]):
        for name in CACHE_FIELDS:
            t = getattr(c, name, None)
            if isinstance(t, torch.Tensor):
                out.append((f"layers/{i}/{name}", t))
    return out


def input_specs(arch: str, shape_name: str, *,
                ocfg: OptimConfig | None = None,
                tcfg: TrainConfig | None = None,
                cfg: ModelConfig | None = None,
                act_sharding=None,
                dist=None,
                quantized: bool = False,
                kv_quant: bool = False,
                moe_rank_major: bool = False,
                profile: str = "2d"):
    """(step_fn, args_tree, kind) for one benchmark cell (``shape_name``: a
    key of ``SHAPES``, or a ``ShapeConfig``).

    train:   step(params_f32, opt_state, batch)         -> params', state', metrics
    prefill: step(params_cdt, batch)                    -> last-token logits
    decode:  step(params_cdt, cache, tokens|embeds)     -> (logits, cache)

    ``dist`` = (mesh, data axes) makes the train step the sharded one
    (its params' spec tree by ``profile``) and sends MoE layers through
    ``moe.apply_sharded``; an ``AbstractMesh`` traces it on ``meta``.
    ``act_sharding`` (the reference's residual-stream spec) changes no
    number in the port (``sharding.py``): it is kept on the step as
    ``step.act_sharding``.  ``quantized``: the serving params as the
    w8a8 records of ``QuantConfig(enabled=True, ent_encode=False)``;
    ``kv_quant``: an int8 decode cache."""
    from repro_torch import sharding

    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    if shape.kind == "decode":
        act_sharding = None   # sequence-sharded activations help full-sequence passes only
    model = Model(cfg, device=META, kv_quant=kv_quant, dist=dist)
    ocfg = ocfg or OptimConfig()
    tcfg = tcfg or default_tcfg(cfg, shape)

    if shape.kind == "train":
        params = abstract_params(cfg)
        opt_state = {"adam": {
            "m": _cast_tree(params, torch.float32),
            "v": _cast_tree(params, torch.float32),
            "step": torch.empty((), dtype=torch.int32, device=META),
        }}
        if dist is None:
            step = make_train_step(model, ocfg, tcfg)
        else:
            step = make_train_step(model, ocfg, tcfg, data_axes=dist[1],
                                   grad_shardings=sharding.params_shardings(
                                       params, dist[0], profile))
        step.act_sharding = act_sharding
        return step, (params, opt_state, batch_specs(cfg, shape)), "train"

    # serving cells run compute-dtype weights; quantized=True the w8a8 records
    params = _fresh(cached_params(cfg, True, quantized))
    if moe_rank_major and cfg.moe is not None and dist is not None:
        from repro_torch.models.moe import rank_major_params
        params = rank_major_params(params, dist[0].shape["model"])
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        step.act_sharding = act_sharding
        b = batch_specs(cfg, shape)
        b.pop("labels")
        return step, (params, b), "prefill"

    # decode: one new token against a seq_len-deep cache
    cache = model.init_cache(shape.global_batch, shape.seq_len, kind=cfg.cache_kind)
    if cfg.modality == "text":
        tok = torch.empty((shape.global_batch,), dtype=torch.int32, device=META)
        step = make_serve_step(model)
        step.act_sharding = None
        return step, (params, cache, tok), "decode"
    emb = torch.empty((shape.global_batch, 1, cfg.d_model), dtype=L.cdtype(cfg), device=META)

    def embed_step(params, cache, embeds):
        return model.decode_step(params, cache, embeds=embeds)

    embed_step.act_sharding = None
    return embed_step, (params, cache, emb), "decode"
