"""Public op: the w8a8 quantized matmul (port of
``repro/kernels/int8_matmul/ops.py``).

``quantized_matmul`` hands its operands to the ``int8_matmul`` kernel,
whose wrapper takes the plain version only for CPU tensors.
``use_kernel=False`` asks for the plain version explicitly (counted in
``quantized_matmul.plain_launches`` on the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cost as C
from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def quantized_matmul(x, w, scale_x, scale_w, *, out_dtype=torch.bfloat16,
                     use_kernel: bool = True):
    """x [M, K] int8, w [K, N] int8, sx [M, 1], sw [1, N] f32 -> [M, N]."""
    if not use_kernel:
        if x.is_cuda:
            quantized_matmul.plain_launches += 1
        return int8_matmul_ref(x, w, scale_x, scale_w, out_dtype)
    return int8_matmul(x.contiguous(), w, scale_x.contiguous(), scale_w, out_dtype)


quantized_matmul.plain_launches = 0


COSTED = ("int8_matmul",)


def cost(name, x, w, scale_x, scale_w, out_dtype=torch.bfloat16):
    """The launch ``int8_matmul`` makes on these arguments: [(kernel,
    {operand type: FLOPs}, bytes)] (``kernels/cost.py``)."""
    return [C.plane_matmul(name, 1, x, w, scale_x, scale_w, out_dtype)]
