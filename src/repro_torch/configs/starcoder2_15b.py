"""StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, LayerNorm+GELU, biases."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    mlp_type="gelu", norm_type="layernorm",
    qkv_bias=True, mlp_bias=True,
    sliding_window=4096,          # StarCoder2 trains with 4k SWA
    rope_theta=1e5,
)
