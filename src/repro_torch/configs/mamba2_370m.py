"""Mamba2-370m [arXiv:2405.21060]: pure SSD, attention-free."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, ngroups=1),
)
