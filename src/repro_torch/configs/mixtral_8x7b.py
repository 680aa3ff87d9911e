"""Mixtral 8x7B [arXiv:2401.04088; hf]: 8-expert top-2 MoE, GQA, SWA."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2),
    sliding_window=4096,          # SWA -> long_500k runnable (O(window) cache)
    rope_theta=1e6,
)
