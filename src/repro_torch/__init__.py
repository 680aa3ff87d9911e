"""PyTorch/CUDA port of the EN-T serving stack (the JAX package ``repro``
is the reference and stays untouched).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; every kernel wrapper launches its hand-written Hopper
kernel on CUDA tensors and takes its plain PyTorch version only for CPU
tensors (see :mod:`repro_torch.device`).

TF32 is switched off here for every float32 matmul and cuDNN
convolution the port runs: the parity contract against the reference
is stated in full float32, and TF32 keeps only ~3 decimal digits.
"""

import torch

# full-precision float32 products everywhere in the port (see docstring)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
