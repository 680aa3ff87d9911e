"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``ent_matmul`` (the EN-T digit-plane matmuls: packed
fused, packed, 4-plane), ``int8_matmul`` (w8a8), ``flash_attention``
(masked flash prefill, the training forward and its backward),
``paged_attention`` (in-place paged decode, bf16 or int8 KV) and
``ssd_scan`` (the Mamba-2 chunked scan and its backward).  Sources live in ``repro_torch/csrc``."""
