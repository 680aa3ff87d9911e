"""LLaVA-NeXT-34B [hf:llava-hf]: VLM; anyres vision tower is a STUB.

input_specs() provides precomputed patch embeddings [B, S, d_model]
(anyres tiling happens in the stub frontend); the backbone is the
Yi-34B-like decoder below.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    modality="vlm", rope_theta=5e6,
)
