"""DBRX base [hf:databricks/dbrx-base]: fine-grained 16-expert top-4 MoE."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4),
    rope_theta=5e5,
)
