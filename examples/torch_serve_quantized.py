"""EN-T quantized serving on the PyTorch port: encode the weights once
into packed digit planes, then generate with the float and the w8a8
params and compare the greedy tokens.  (The reference example's modeled
TCU savings come from ``core/hwmodel.py``, which the port does not carry.)

    PYTHONPATH=src python examples/torch_serve_quantized.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.models.transformer import Model
from repro_torch.quant.quantize import quantize_params
from repro_torch.runtime.serve_loop import generate

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen2.5-3b")
ap.add_argument("--device", default=None, choices=["cuda", "cpu"], help="default: cuda")
args = ap.parse_args()

cfg = reduced_config(get_config(args.arch))
model = Model(cfg, device=args.device)
gen = torch.Generator(device=model.device)
gen.manual_seed(0)
params = model.init(gen)

# The edge encoder runs ONCE here: every projection becomes int8 codes +
# per-channel scales + packed EN-T digit planes.
qparams = quantize_params(params, QuantConfig(enabled=True, ent_encode=True))


def count_planes(node):
    if isinstance(node, dict):
        return sum(v.numel() if k == "planes_packed" else count_planes(v)
                   for k, v in node.items())
    if isinstance(node, list):
        return sum(count_planes(v) for v in node)
    return 0


print(f"quantized {cfg.name}: {count_planes(qparams) / 1e6:.2f}M packed plane entries "
      "(computed once, reused every serving step)")

prompt = np.asarray([[1, 5, 9, 12]])
f_out = generate(model, params, prompt, steps=8).cpu().numpy()
q_out = generate(model, qparams, prompt, steps=8).cpu().numpy()
print("float tokens :", f_out[0].tolist())
print("w8a8  tokens :", q_out[0].tolist())
print(f"greedy agreement: {np.mean(f_out == q_out) * 100:.0f}%")
