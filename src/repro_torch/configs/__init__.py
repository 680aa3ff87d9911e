"""Architecture registry: ``get_config("<arch-id>")`` resolves --arch flags.

Every assigned architecture (plus the reduced smoke variants) lives here.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

from repro_torch.configs.base import (  # noqa: F401
    MeshConfig, ModelConfig, MoEConfig, OptimConfig, QuantConfig, RunConfig,
    SHAPES, ShapeConfig, SSMConfig, TrainConfig,
)

_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2-72b": "qwen2_72b",
    "jamba-1.5-large": "jamba_1_5_large",
    "musicgen-medium": "musicgen_medium",
    "mamba2-370m": "mamba2_370m",
    "llava-next-34b": "llava_next_34b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_optim(arch: str) -> OptimConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return getattr(mod, "OPTIM", OptimConfig())


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/topology at toy scale — used by per-arch smoke tests.

    Keeps: group pattern, GQA ratio, mlp/norm type, biases, modality,
    MoE top_k, tied embeddings.  Shrinks: widths, depth, vocab, experts.
    """
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = heads if cfg.num_kv_heads == cfg.num_heads else max(1, heads // 2)
    # capacity_factor = E/k => capacity == num tokens: dropless at toy
    # scale, so decode matches prefill exactly in the consistency tests
    moe = (replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                   capacity_factor=4 / min(cfg.moe.top_k, 2))
           if cfg.moe else None)
    ssm = (replace(cfg.ssm, state_dim=16, head_dim=16, expand=2,
                   ngroups=min(cfg.ssm.ngroups, 2)) if cfg.ssm else None)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2 * len(cfg.group),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else None,
        moe=moe,
        ssm=ssm,
        param_dtype="float32",
        compute_dtype="float32",
    )
