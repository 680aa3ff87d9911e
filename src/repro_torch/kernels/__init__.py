"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``ent_matmul`` (packed fused EN-T matmul),
``flash_attention`` (masked flash prefill) and ``paged_attention``
(in-place paged decode).  Sources live in ``repro_torch/csrc``."""
