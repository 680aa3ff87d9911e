"""Decoder-only LM for training and serving (port of
``repro/models/transformer.py``).

The reference stacks each group position's params ``[G, ...]`` and
traverses them with ``jax.lax.scan``; the port keeps one param dict per
layer under ``params["layers"]`` (layer ``g * len(group) + i`` has spec
``cfg.group[i]``) and loops over the layers.  The port runs attention
and SSM (Mamba-2) mixers with dense, MoE or no FFN, in training and in
serving: an SSM layer serves from an ``SSMCache`` (its conv window and
SSD state), an MoE layer returns its Switch auxiliary loss, which the
full-sequence forward sums into ``aux_loss`` (and the training loss).
``Model.verify_step`` runs speculative decoding's verify burst (S tokens
per sequence at per-sequence depths in one pass), with each SSM layer's
per-step states for ``select_ssm_states``.
``Model.apply`` without a cache is the full-sequence (training)
forward, with the reference's remat policies: ``remat="full"``
recomputes each layer group in the backward
(``torch.utils.checkpoint``), ``remat="dots"`` keeps the outputs of the
2-D projection matmuls and recomputes the rest, the SSD scan included
(a selective-checkpoint policy, the counterpart of
``checkpoint_dots_with_no_batch_dims``).

``embeds=`` ([B, S, D], cast to the compute dtype) stands in for
``tokens`` on ``apply``, ``prefill`` and ``decode_step``, as in the
reference: the audio and VLM configs' stub frontends hand the backbone
frame or patch embeddings.  ``init_cache(kind="auto")`` resolves to the
sliding-window ring for windowed models and dense rows otherwise.

``Model(..., dist=(mesh, data_axes))`` sends every MoE FFN through
``moe.apply_sharded`` (the training forward, prefill, decode and
verify), as the reference's ``_moe_apply`` does; every tensor a layer
sees is then the rank's own rows (``sharding.batch_pspec``) and the
params are whole (the train step gathers them).

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
from repro_torch.models import attention, layers as L, moe, ssm
from repro_torch.quant.quantize import quantize_params


def _check_spec(spec):
    mixer, ffn = spec
    if mixer not in ("attn", "ssm") or ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"layer spec {spec} is not ported: the port runs attention and SSM "
            "mixers with dense, MoE or no FFN")


# remat="dots": the 2-D projection products whose outputs are kept
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Model:
    """Decoder-only LM: init / apply (full-sequence forward, or cache
    write-through prefill) / init_cache / prefill / decode_step."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, kv_quant: bool = False, dist=None):
        for spec in cfg.group:
            _check_spec(spec)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.kv_quant = kv_quant    # int8 KV cache (decode)
        self.dist = dist            # (mesh, data axes): MoE FFNs expert-parallel

    def _ffn(self, spec, p, x, rows: bool = False):
        """The layer's FFN residual: (x, the MoE auxiliary loss or None)."""
        if spec[1] == "none":
            return x, None
        h = L.norm_apply(self.cfg, p["ffn_norm"], x)
        if spec[1] == "moe":
            if self.dist is not None:
                mesh, data_axes = self.dist
                y, aux = moe.apply_sharded(self.cfg, p["ffn"], h, mesh, data_axes)
            else:
                y, aux = moe.apply(self.cfg, p["ffn"], h, rows)
            return x + y, aux
        return x + L.mlp_apply(self.cfg, p["ffn"], h, self.use_kernels, rows), None

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
        if ffn in ("dense", "moe"):
            p["ffn_norm"] = L.norm_init(cfg, cfg.d_model, generator.device)
            p["ffn"] = L.mlp_init(generator, cfg) if ffn == "dense" else moe.init(generator, cfg)
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
        """One group's layers: (x, the sum of their MoE auxiliary losses)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, spec in zip(layers, specs):
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            mod = ssm if spec[0] == "ssm" else attention
            x = x + mod.apply(cfg, p["mixer"], h, use_kernel=self.use_kernels)
            x, a = self._ffn(spec, p, x)
            if a is not None:
                aux = aux + a
        return x, aux

    def _embed(self, params, tokens, embeds):
        """The layer stack's input: ``tokens`` embedded, or ``embeds`` in the
        compute dtype."""
        if embeds is None:
            return L.embed_apply(self.cfg, params["embed"], tokens)
        return embeds.to(L.cdtype(self.cfg))

    def _forward(self, params, tokens, remat: str, embeds=None):
        """Embedding and the layer stack, each group of ``len(cfg.group)``
        layers under the remat policy: (x, the MoE auxiliary losses summed
        over the groups).  The layers draw no random numbers, so
        recomputation keeps no RNG state."""
        cfg = self.cfg
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none | full | dots, got {remat!r}")
        x = self._embed(params, tokens, embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = len(cfg.group)
        for g in range(cfg.num_groups):
            body = functools.partial(self._group_apply,
                                     params["layers"][g * n:(g + 1) * n], cfg.group)
            if remat == "none":
                x, a = body(x)
            elif remat == "full":
                x, a = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False,
                                  context_fn=functools.partial(
                                      create_selective_checkpoint_contexts, _save_dots))
            aux = aux + a
        return x, aux

    def apply(self, params, tokens=None, *, embeds=None, labels=None, remat: str = "none",
              fused_loss: bool = False, cache=None, write_cache: bool = False,
              last_only: bool = False, pad_mask=None, pos0: int = 0,
              start=None, need_logits: bool = True, peek: bool = False,
              last_index: int | None = None):
        """Without ``write_cache``: the full-sequence forward of ``tokens``
        [B, S] (or ``embeds`` [B, S, D]; training), returning {"logits" [B,
        S, V_padded] f32 (not with ``fused_loss``), "aux_loss"} and, given
        ``labels``, "loss" and "ce_loss"; ``fused_loss`` never materializes
        the logits.

        With ``write_cache``: cache write-through prefill of chunk
        ``[pos0, pos0+S)``.  ``pad_mask`` ([B, S] bool, True = real token)
        marks LEFT padding of the first chunk; ``start`` overrides the pad
        count derived from it.  Returns {"logits", "cache"}.

        ``peek=True`` runs the chunk read-only: the logits are what a
        writing prefill gives, but no pool is written and ``pos`` does
        not advance (how serving recovers the last token's logits for a
        fully prefix-cached prompt without copying its shared pages).
        ``last_index`` picks the row whose logits ``last_only`` returns
        instead of the last one: a tail-padded chunk's last real row."""
        cfg = self.cfg
        if not write_cache:
            return self._apply_full(params, tokens, labels, remat, fused_loss,
                                    last_only, embeds)
        if peek and any(m == "ssm" for m, _ in cfg.group):
            raise ValueError("peek prefill is attention-only: an SSM layer must write "
                             "its recurrent state through")
        if cache is None:
            raise ValueError("write_cache=True requires a cache from init_cache")
        cpos = torch.as_tensor(cache["pos"]).cpu()
        if bool((cpos != pos0).any()):
            raise ValueError(f"write_cache prefill chunk at pos0={pos0} "
                             f"requires the cache there; got pos={cpos.tolist()}")
        x = self._embed(params, tokens, embeds)
        s = x.shape[1]
        if start is None and pad_mask is not None and pos0 == 0:
            start = s - pad_mask.to(torch.int32).sum(dim=1)
        if start is not None:
            start = start.to(torch.int32)
        rows = attention.plain_path(x, self.use_kernels)
        # an SSM layer's pads: the positions before each row's start
        ssm_mask = None
        if start is not None and any(m == "ssm" for m, _ in cfg.group):
            ssm_mask = (pos0 + torch.arange(s, device=x.device))[None, :] >= start[:, None]
        layers = list(cache["layers"])
        for i, spec in enumerate(self._specs()):
            p = params["layers"][i]
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            if spec[0] == "ssm":
                y, layers[i] = ssm.prefill_step(cfg, p["mixer"], h, layers[i], mask=ssm_mask,
                                                use_kernel=self.use_kernels)
            else:
                y, layers[i] = attention.prefill_step(
                    cfg, p["mixer"], h, layers[i], start=start, pos0=pos0,
                    use_kernel=self.use_kernels, write=not peek)
            x, _ = self._ffn(spec, p, x + y, rows)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        new_cache["pos"] = cache["pos"] + (0 if peek else s)
        if start is not None:
            new_cache["start"] = start
        out = {"cache": new_cache}
        if not need_logits:
            return out
        if last_only:
            if last_index is None:
                x = x[:, -1:, :]
            elif 0 <= last_index < s:
                x = x[:, last_index:last_index + 1, :]
            else:
                raise ValueError(f"last_index {last_index} outside the chunk's {s} rows")
        x = L.norm_apply(cfg, params["final_norm"], x)
        out["logits"] = L.lm_head_apply(cfg, params.get("lm_head"),
                                        params["embed"], x, rows)
        return out

    def _apply_full(self, params, tokens, labels, remat, fused_loss, last_only,
                    embeds=None):
        cfg = self.cfg
        x, aux = self._forward(params, tokens, remat, embeds)
        out = {"aux_loss": aux}
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
        """One cache per layer: for an attention layer a KV backend,
        ``"paged"``, ``"dense"``, ``"ring"`` or ``"auto"`` (the ring for
        sliding-window models, dense rows otherwise;
        ``attention.init_cache``), ``cache_kw`` (page_size, pages, mapped)
        configuring the paged pool; for an SSM layer its ``SSMCache``."""
        cfg = self.cfg
        layers = [ssm.init_cache(cfg, batch, L.cdtype(cfg), device=self.device)
                  if spec[0] == "ssm" else
                  attention.init_cache(cfg, batch, max_len, L.cdtype(cfg),
                                       quantized=self.kv_quant, kind=kind,
                                       device=self.device, **cache_kw)
                  for spec in self._specs()]
        return {"layers": layers, "pos": 0}

    def decode_step(self, params, cache, tokens=None, token_mask=None, embeds=None):
        """One token for the whole batch.  tokens: [B] int (or ``embeds``
        [B, 1, D]).  ``cache["pos"]``
        is an int or a [B] int32 tensor; ``cache.get("start")`` marks
        left-pad slots.  ``token_mask`` ([B] bool, as the reference's)
        marks the current token as a pad (sequential prefill of a ragged
        batch): attention layers keep it out of every later query through
        ``start`` alone, so the step is the same with or without it; SSM
        layers zero its conv input and carry their state through.  Returns
        (logits [B, V], cache)."""
        x = self._embed(params, None if tokens is None else tokens[:, None], embeds)
        if token_mask is not None and (token_mask.shape != x.shape[:1]
                                       or token_mask.dtype != torch.bool):
            raise ValueError(f"token_mask must be bool [{x.shape[0]}], got "
                             f"{token_mask.dtype} {tuple(token_mask.shape)}")
        cfg = self.cfg
        pos = cache["pos"]
        start = cache.get("start")
        rows = attention.plain_path(x, self.use_kernels)
        layers = list(cache["layers"])
        for i, spec in enumerate(self._specs()):
            p = params["layers"][i]
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            if spec[0] == "ssm":
                y, layers[i] = ssm.decode_step(cfg, p["mixer"], h, layers[i],
                                               token_mask=token_mask,
                                               use_kernel=self.use_kernels)
            else:
                y, layers[i] = attention.decode_step(
                    cfg, p["mixer"], h, layers[i], pos, start=start,
                    use_kernel=self.use_kernels)
            x, _ = self._ffn(spec, p, x + y, rows)
        x = L.norm_apply(cfg, params["final_norm"], x)
        logits = L.lm_head_apply(cfg, params.get("lm_head"), params["embed"], x, rows)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        new_cache["pos"] = pos + 1
        return logits[:, 0], new_cache

    def verify_step(self, params, cache, tokens):
        """Speculative verify burst: S tokens for the whole batch at the
        per-slot depths ``cache["pos"]``.  tokens: [B, S] (column 0 the
        already sampled next token, then the drafts).  Returns (logits
        [B, S, V], cache at pos + S, states): position t's logits are what
        decode at ``pos + t`` gives after the same prefix (bit for bit on
        the plain path).  ``states`` has one entry per layer: None for an
        attention layer, whose rollback is the caller's ``pos`` reset; for
        an SSM layer its per-step states (an ``SSMCache`` of [B, S, ...]
        leaves) for ``select_ssm_states``."""
        cfg = self.cfg
        pos = cache["pos"]
        start = cache.get("start")
        x = L.embed_apply(cfg, params["embed"], tokens)
        rows = attention.plain_path(x, self.use_kernels)
        layers = list(cache["layers"])
        states = [None] * len(layers)
        for i, spec in enumerate(self._specs()):
            p = params["layers"][i]
            h = L.norm_apply(cfg, p["mixer_norm"], x)
            if spec[0] == "ssm":
                y, layers[i], states[i] = ssm.verify_step(cfg, p["mixer"], h, layers[i],
                                                          use_kernel=self.use_kernels)
            else:
                y, layers[i] = attention.verify_step(
                    cfg, p["mixer"], h, layers[i], pos, start=start,
                    use_kernel=self.use_kernels)
            x, _ = self._ffn(spec, p, x + y, rows)
        x = L.norm_apply(cfg, params["final_norm"], x)
        logits = L.lm_head_apply(cfg, params.get("lm_head"), params["embed"], x, rows)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        new_cache["pos"] = pos + tokens.shape[1]
        return logits, new_cache, states

    def select_ssm_states(self, layers, states, sel):
        """Roll every SSM layer cache back to its state after step ``sel[b]``
        of a burst (``states``: ``verify_step``'s, or a drafter's per-step
        snapshots stacked the same way); the other layers' caches pass
        through.  Returns the layers, updated in place."""
        for c, st in zip(layers, states):
            if st is not None:
                one = ssm.select_state(st, sel)
                c.update(one.conv, one.ssd)
        return layers

    def _attn_width(self, cache) -> int | None:
        """Rows per sequence of the attention cache (None: attention-free),
        the per-chunk prefill bound."""
        for c, spec in zip(cache["layers"], self._specs()):
            if spec[0] == "attn":
                return c.width
        return None

    def prefill(self, params, cache, tokens=None, pad_mask=None,
                chunk: int | None = None, pos0: int = 0, embeds=None):
        """Batched serving prefill of ``tokens`` [B, S0] (or ``embeds`` [B,
        S0, D]): (last-token logits [B, V], cache at pos0 + S0).  ``chunk``
        (or ``cfg.prefill_chunk``) splits the prompt into cache-write-through
        chunks, and so does a prompt past the cache's width (a ring it would
        wrap: chunks of at most W rows)."""
        s0 = (tokens if tokens is not None else embeds).shape[1]
        if pos0 and pad_mask is not None:
            raise ValueError("pos0 > 0 resumes an unpadded prompt; pad_mask "
                             "is unsupported on the resumed-suffix path")
        chunk = chunk if chunk is not None else self.cfg.prefill_chunk
        width = self._attn_width(cache)
        if chunk is None and (width is None or pos0 + s0 <= width):
            out = self.apply(params, tokens, embeds=embeds, cache=cache, write_cache=True,
                             last_only=True, pad_mask=pad_mask, pos0=pos0)
            return out["logits"][:, 0], out["cache"]
        c = chunk or width
        if width is not None:
            c = min(c, width)
        c = max(int(c), 1)
        start = None
        if pad_mask is not None:
            start = s0 - pad_mask.to(torch.int32).sum(dim=1)
        logits = None
        for lo in range(0, s0, c):
            hi = min(lo + c, s0)
            out = self.apply(params, None if tokens is None else tokens[:, lo:hi],
                             embeds=None if embeds is None else embeds[:, lo:hi],
                             cache=cache, write_cache=True, last_only=True,
                             pos0=pos0 + lo, start=start, need_logits=(hi == s0))
            cache = out["cache"]
            if hi == s0:
                logits = out["logits"][:, 0]
        return logits, cache


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)


def loss_fn(model: Model, params, batch, remat: str = "none",
            fused_loss: bool = False):
    """Scalar training loss of a {"tokens" (or "embeds"), "labels"} batch:
    (loss, {"ce_loss", "aux_loss"})."""
    out = model.apply(params, batch.get("tokens"), embeds=batch.get("embeds"),
                      labels=batch["labels"], remat=remat, fused_loss=fused_loss)
    return out["loss"], {"ce_loss": out["ce_loss"], "aux_loss": out["aux_loss"]}
