"""Jamba-1.5-Large [arXiv:2403.19887]: Mamba+attn 1:7 hybrid, 16e top-2 MoE.

Group of 8 layers: attention at period offset 4, MoE every other layer
(odd offsets), per the Jamba block structure.  The Mamba mixers are
modeled with the SSD (Mamba-2) formulation (see DESIGN.md §Adaptation).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_GROUP = tuple(
    ("attn" if i == 4 else "ssm", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, ngroups=8),
    group=_GROUP,
)
