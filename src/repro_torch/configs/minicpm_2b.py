"""MiniCPM-2B [arXiv:2404.06395]: llama-like MHA, tied embeddings, WSD."""
from dataclasses import replace
from repro_torch.configs.base import ModelConfig, OptimConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
)
# MiniCPM's signature warmup-stable-decay schedule
OPTIM = OptimConfig(schedule="wsd", warmup_steps=100, wsd_decay_frac=0.1)
