"""Decoder-only LM for training and serving (port of
``repro/models/transformer.py``).

The reference stacks each group position's params ``[G, ...]`` and
traverses them with ``jax.lax.scan``; the port keeps one param dict per
layer under ``params["layers"]`` (layer ``g * len(group) + i`` has spec
``cfg.group[i]``) and loops over the layers.  The port runs attention
and SSM (Mamba-2) mixers with dense or no FFN; ``moe`` layer specs
raise ``NotImplementedError``, and so do the serving entry points
(``init_cache``, ``prefill``, ``decode_step``,
``apply(write_cache=True)``) of a model with SSM layers.
``Model.apply`` without a cache is the full-sequence (training)
forward, with the reference's remat policies: ``remat="full"``
recomputes each layer group in the backward
(``torch.utils.checkpoint``), ``remat="dots"`` keeps the outputs of the
2-D projection matmuls and recomputes the rest, the SSD scan included
(a selective-checkpoint policy, the counterpart of
``checkpoint_dots_with_no_batch_dims``).

``Model(..., kv_quant=True)`` serves from an int8 KV cache with bf16
per-(row, head) scales, as the reference's ``Model(kv_quant=True)``.
``Model(..., use_kernels=False)`` runs every kernel's plain PyTorch
version instead, on any device — the explicit switch a kernel-vs-plain
comparison uses.  By default the kernels run on CUDA tensors and the
plain versions on CPU tensors.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers as L, ssm
from repro_torch.quant.quantize import quantize_params


def _check_spec(spec):
    mixer, ffn = spec
    if mixer not in ("attn", "ssm") or ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"layer spec {spec} is not ported yet: the port runs attention "
            "and SSM mixers with dense or no FFN (MoE: ROADMAP queue 2 item 8)")


# remat="dots": the 2-D projection products whose outputs are kept
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Model:
    """Decoder-only LM: init / apply (full-sequence forward, or cache
    write-through prefill) / init_cache / prefill / decode_step."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, kv_quant: bool = False):
        for spec in cfg.group:
            _check_spec(spec)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.kv_quant = kv_quant    # int8 KV cache (decode)

    def _check_serving(self):
        if any(mixer == "ssm" for mixer, _ in self.cfg.group):
            raise NotImplementedError(ssm.SERVING_UNPORTED)

    def _specs(self):
        return [self.cfg.group[i % len(self.cfg.group)]
                for i in range(self.cfg.num_layers)]

    # .. params ..
    def init_layer(self, generator, spec):
        cfg = self.cfg
        mixer, ffn = spec
        mod = ssm if mixer == "ssm" else attention
        p = {"mixer_norm": L.norm_init(cfg, cfg.d_model, generator.device),
             "mixer": mod.init(generator, cfg)}
        if ffn == "dense":
            p["ffn_norm"] = L.norm_init(cfg, cfg.d_model, generator.device)
            p["ffn"] = L.mlp_init(generator, cfg)
        return p

    def init(self, generator: torch.Generator, quant: QuantConfig | None = None):
        """Random params from ``generator`` (on the model's device).  With
        ``quant``, each layer is quantized as soon as it is made, so the
        float weights of all layers never sit on the device at once.
        Without it every leaf is a float tensor in ``cfg.param_dtype``
        (float32 by default): the master weights that training makes
        leaves with ``requires_grad``."""
        cfg = self.cfg
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        params = {"embed": L.embed_init(generator, cfg),
                  "final_norm": L.norm_init(cfg, cfg.d_model, self.device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, cfg, cfg.d_model,
                                             cfg.padded_vocab)
        layers = []
        for i, spec in enumerate(self._specs()):
            layer = self.init_layer(generator, spec)
            if quant is not None:
                layer = quantize_params(layer, quant, f"/layers/{i}")
            layers.append(layer)
        params["layers"] = layers
        return params

    # .. full-sequence forward (train) ..
    def _group_apply(self, layers, specs, x):
        cfg = self.cfg
        for p, spec in zip(layers, specs):
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            mod = ssm if spec[0] == "ssm" else attention
            x = x + mod.apply(cfg, p["mixer"], h, use_kernel=self.use_kernels)
            if spec[1] == "dense":
                h = L.norm_apply(cfg, p["ffn_norm"], x)
                x = x + L.mlp_apply(cfg, p["ffn"], h, self.use_kernels)
        return x

    def _forward(self, params, tokens, remat: str):
        """Embedding and the layer stack, each group of ``len(cfg.group)``
        layers under the remat policy.  The layers draw no random numbers,
        so recomputation keeps no RNG state."""
        cfg = self.cfg
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none | full | dots, got {remat!r}")
        x = L.embed_apply(cfg, params["embed"], tokens)
        n = len(cfg.group)
        for g in range(cfg.num_groups):
            body = functools.partial(self._group_apply,
                                     params["layers"][g * n:(g + 1) * n], cfg.group)
            if remat == "none":
                x = body(x)
            elif remat == "full":
                x = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False,
                               context_fn=functools.partial(
                                   create_selective_checkpoint_contexts, _save_dots))
        return x

    def apply(self, params, tokens=None, *, labels=None, remat: str = "none",
              fused_loss: bool = False, cache=None, write_cache: bool = False,
              last_only: bool = False, pad_mask=None, pos0: int = 0,
              start=None, need_logits: bool = True):
        """Without ``write_cache``: the full-sequence forward of ``tokens``
        [B, S] (training), returning {"logits" [B, S, V_padded] f32 (not
        with ``fused_loss``), "aux_loss"} and, given ``labels``, "loss" and
        "ce_loss"; ``fused_loss`` never materializes the logits.

        With ``write_cache``: cache write-through prefill of chunk
        ``[pos0, pos0+S)``.  ``pad_mask`` ([B, S] bool, True = real token)
        marks LEFT padding of the first chunk; ``start`` overrides the pad
        count derived from it.  Returns {"logits", "cache"}."""
        cfg = self.cfg
        if not write_cache:
            return self._apply_full(params, tokens, labels, remat, fused_loss,
                                    last_only)
        self._check_serving()
        if cache is None:
            raise ValueError("write_cache=True requires a cache from init_cache")
        cpos = torch.as_tensor(cache["pos"]).cpu()
        if bool((cpos != pos0).any()):
            raise ValueError(f"write_cache prefill chunk at pos0={pos0} "
                             f"requires the cache there; got pos={cpos.tolist()}")
        x = L.embed_apply(cfg, params["embed"], tokens)
        s = x.shape[1]
        if start is None and pad_mask is not None and pos0 == 0:
            start = s - pad_mask.to(torch.int32).sum(dim=1)
        if start is not None:
            start = start.to(torch.int32)
        rows = attention.plain_path(x, self.use_kernels)
        layers = list(cache["layers"])
        for i, spec in enumerate(self._specs()):
            p = params["layers"][i]
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            y, layers[i] = attention.prefill_step(
                cfg, p["mixer"], h, layers[i], start=start, pos0=pos0,
                use_kernel=self.use_kernels)
            x = x + y
            if spec[1] == "dense":
                h = L.norm_apply(cfg, p["ffn_norm"], x)
                x = x + L.mlp_apply(cfg, p["ffn"], h, self.use_kernels, rows)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        new_cache["pos"] = cache["pos"] + s
        if start is not None:
            new_cache["start"] = start
        out = {"cache": new_cache}
        if not need_logits:
            return out
        if last_only:
            x = x[:, -1:, :]
        x = L.norm_apply(cfg, params["final_norm"], x)
        out["logits"] = L.lm_head_apply(cfg, params.get("lm_head"),
                                        params["embed"], x, rows)
        return out

    def _apply_full(self, params, tokens, labels, remat, fused_loss, last_only):
        cfg = self.cfg
        x = self._forward(params, tokens, remat)
        # attention, SSM and dense layers carry no auxiliary loss (MoE's is
        # unported)
        out = {"aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
        if last_only:
            x = x[:, -1:, :]
        x = L.norm_apply(cfg, params["final_norm"], x)
        head = params.get("lm_head")
        if fused_loss:
            if labels is None:
                raise ValueError("fused_loss needs labels")
            ce = L.fused_cross_entropy(cfg, head, params["embed"], x, labels)
            out["loss"] = ce + out["aux_loss"]
            out["ce_loss"] = ce
            return out
        logits = L.lm_head_apply(cfg, head, params["embed"], x)
        out["logits"] = logits
        if labels is not None:
            ce = L.cross_entropy(logits, labels, cfg.vocab_size)
            out["loss"] = ce + out["aux_loss"]
            out["ce_loss"] = ce
        return out

    # .. decode ..
    def init_cache(self, batch: int, max_len: int, kind: str = "paged",
                   **cache_kw):
        """One KV backend per layer (``"paged"`` or ``"dense"``);
        ``cache_kw`` (page_size, pages, mapped) configures the paged pool."""
        self._check_serving()
        cfg = self.cfg
        layers = [attention.init_cache(cfg, batch, max_len, L.cdtype(cfg),
                                       quantized=self.kv_quant, kind=kind,
                                       device=self.device, **cache_kw)
                  for _ in range(cfg.num_layers)]
        return {"layers": layers, "pos": 0}

    def decode_step(self, params, cache, tokens, token_mask=None):
        """One token for the whole batch.  tokens: [B] int.  ``cache["pos"]``
        is an int or a [B] int32 tensor; ``cache.get("start")`` marks
        left-pad slots.  ``token_mask`` ([B] bool, as the reference's)
        marks the current token as a pad (sequential prefill of a ragged
        batch): attention layers keep it out of every later query through
        ``start`` alone, so the step is the same with or without it (the
        reference's SSM layers carry their state through on a pad; SSM
        serving is not ported).  Returns (logits [B, V], cache)."""
        self._check_serving()
        if token_mask is not None and (token_mask.shape != tokens.shape[:1]
                                       or token_mask.dtype != torch.bool):
            raise ValueError(f"token_mask must be bool [{tokens.shape[0]}], got "
                             f"{token_mask.dtype} {tuple(token_mask.shape)}")
        cfg = self.cfg
        pos = cache["pos"]
        start = cache.get("start")
        x = L.embed_apply(cfg, params["embed"], tokens[:, None])
        rows = attention.plain_path(x, self.use_kernels)
        layers = list(cache["layers"])
        for i, spec in enumerate(self._specs()):
            p = params["layers"][i]
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            y, layers[i] = attention.decode_step(
                cfg, p["mixer"], h, layers[i], pos, start=start,
                use_kernel=self.use_kernels)
            x = x + y
            if spec[1] == "dense":
                h = L.norm_apply(cfg, p["ffn_norm"], x)
                x = x + L.mlp_apply(cfg, p["ffn"], h, self.use_kernels, rows)
        x = L.norm_apply(cfg, params["final_norm"], x)
        logits = L.lm_head_apply(cfg, params.get("lm_head"), params["embed"], x, rows)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        new_cache["pos"] = pos + 1
        return logits[:, 0], new_cache

    def prefill(self, params, cache, tokens, pad_mask=None,
                chunk: int | None = None, pos0: int = 0):
        """Batched serving prefill: (last-token logits [B, V], cache at
        pos0 + S0).  ``chunk`` (or ``cfg.prefill_chunk``) splits the
        prompt into cache-write-through chunks."""
        self._check_serving()
        s0 = tokens.shape[1]
        if pos0 and pad_mask is not None:
            raise ValueError("pos0 > 0 resumes an unpadded prompt; pad_mask "
                             "is unsupported on the resumed-suffix path")
        chunk = chunk if chunk is not None else self.cfg.prefill_chunk
        width = cache["layers"][0].width
        if chunk is None and pos0 + s0 <= width:
            out = self.apply(params, tokens, cache=cache, write_cache=True,
                             last_only=True, pad_mask=pad_mask, pos0=pos0)
            return out["logits"][:, 0], out["cache"]
        c = max(int(min(chunk or width, width)), 1)
        start = None
        if pad_mask is not None:
            start = s0 - pad_mask.to(torch.int32).sum(dim=1)
        logits = None
        for lo in range(0, s0, c):
            hi = min(lo + c, s0)
            out = self.apply(params, tokens[:, lo:hi], cache=cache,
                             write_cache=True, last_only=True,
                             pos0=pos0 + lo, start=start,
                             need_logits=(hi == s0))
            cache = out["cache"]
            if hi == s0:
                logits = out["logits"][:, 0]
        return logits, cache


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)


def loss_fn(model: Model, params, batch, remat: str = "none",
            fused_loss: bool = False):
    """Scalar training loss of a {"tokens", "labels"} batch: (loss,
    {"ce_loss", "aux_loss"})."""
    out = model.apply(params, batch["tokens"], labels=batch["labels"],
                      remat=remat, fused_loss=fused_loss)
    return out["loss"], {"ce_loss": out["ce_loss"], "aux_loss": out["aux_loss"]}
