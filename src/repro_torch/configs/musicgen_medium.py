"""MusicGen-medium [arXiv:2306.05284]: decoder over EnCodec tokens.

The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [B, S, d_model]; the backbone is this
standard decoder (LayerNorm + GELU MLP, MHA).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    mlp_type="gelu", norm_type="layernorm",
    modality="audio",
)
