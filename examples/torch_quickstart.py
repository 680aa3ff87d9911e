"""Quickstart on the PyTorch port: the EN-T arithmetic, the hardware
model's headline and a tiny model forward (port of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the digit-plane matmul runs kernel 5 (four planes) and the
packed form kernel 4, each with its int32 accumulator as the output, and
the model step builds reduced mixtral-8x7b there, its heads widened from
16 to 64 (the smallest head_dim of the port's attention kernels);
``--device cpu`` runs the plain versions.
"""

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import encoding, hwmodel, multiplier
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"], help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. The paper's encoding: 78 -> {0, 1, 1, -1, 2}  (sign, digits MSB-first)
    sign, w, carry = encoding.ent_encode_signed(torch.tensor(78, device=dev), 8)
    print("Encode(78) =", [int(sign)] + [int(d) for d in w.cpu().numpy()[::-1]],
          "->", "78 = 4^3 + 4^2 - 4 + 2 =", 64 + 16 - 4 + 2)

    # 2. Encode once, reuse everywhere: the digit-plane and packed matmuls
    #    are bit-exact
    rng = np.random.default_rng(0)
    x_np = rng.integers(-128, 128, (8, 64), dtype=np.int8)
    w_np = rng.integers(-128, 128, (64, 32), dtype=np.int8)
    want = x_np.astype(np.int32) @ w_np.astype(np.int32)
    x, wt = torch.from_numpy(x_np).to(dev), torch.from_numpy(w_np).to(dev)
    planes = multiplier.ent_digit_planes(wt)             # the hoisted encoder
    out = multiplier.ent_plane_matmul(x, planes)
    assert (out.cpu().numpy() == want).all()
    print("digit-plane matmul == int32 matmul: bit-exact")
    packed = multiplier.pack_planes(planes)
    assert (multiplier.ent_packed_matmul(x, packed).cpu().numpy() == want).all()
    print("packed-plane matmul (2 planes) == int32 matmul: bit-exact")

    # 3. What EN-T buys in silicon (the paper's Fig 7 headline)
    for scale in ("256GOPS", "1TOPS", "4TOPS"):
        avg = hwmodel.scale_average(scale)
        print(f"  {scale}: area-eff +{avg['area_eff'] * 100:.1f}%  "
              f"energy-eff +{avg['energy_eff'] * 100:.1f}%")

    # 4. A model from the zoo, one forward
    cfg = replace(reduced_config(get_config("mixtral-8x7b")), head_dim=64)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)
    toks = torch.ones((2, 16), dtype=torch.int64, device=model.device)
    with torch.no_grad():
        res = model.apply(params, toks, labels=toks)
    print(f"{cfg.name}: loss={float(res['loss']):.3f} "
          f"(moe aux={float(res['aux_loss']):.4f})")
    return float(res["loss"])


if __name__ == "__main__":
    main()
