"""Layer tables for the paper's SoC benchmark networks (§4.4, Figs 9-12).

Programmatic generators for the 8 CNNs the paper runs single-frame
(1,3,224,224) inference on: ResNet-34/50/101, VGG-13/19, DenseNet-121/161,
Inception-V3.  Each network is a list of :class:`ConvLayer` /
:class:`LinearLayer` records carrying exactly what the SoC energy model
needs: GEMM dims after im2col (M = H_out*W_out, K = Cin*k*k/groups,
N = Cout), MAC counts, and weight/activation byte counts.

MAC totals are validated against literature values in tests
(e.g. ResNet-50 ~4.09 GMACs for 224x224).

The port's copy of ``repro/core/networks.py`` (the port imports
nothing of the JAX package): the same constants, functions and names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["ConvLayer", "network", "NETWORKS", "total_macs", "total_weight_bytes"]


@dataclass(frozen=True)
class ConvLayer:
    """One GEMM-shaped op (conv via im2col, or FC with h=w=k=1)."""

    name: str
    cin: int
    cout: int
    k: int
    h_out: int
    w_out: int
    groups: int = 1

    @property
    def m(self) -> int:  # GEMM rows (output pixels)
        return self.h_out * self.w_out

    @property
    def kdim(self) -> int:  # GEMM reduction
        return self.cin * self.k * self.k // self.groups

    @property
    def n(self) -> int:  # GEMM cols
        return self.cout

    @property
    def macs(self) -> int:
        return self.m * self.kdim * self.n * self.groups // 1  # groups folded in kdim

    @property
    def weight_bytes(self) -> int:  # INT8
        return self.cout * self.kdim

    @property
    def out_bytes(self) -> int:
        return self.m * self.cout

    @property
    def im2col_bytes(self) -> int:
        return self.m * self.kdim * self.groups


def _conv(name, cin, cout, k, hin, stride=1, groups=1, pad=None):
    if pad is None:
        pad = k // 2
    h_out = (hin + 2 * pad - k) // stride + 1
    return ConvLayer(name, cin, cout, k, h_out, h_out, groups), h_out


# --------------------------------------------------------------------------
# VGG-13 / VGG-19 (configs B / E; two FC-4096 + FC-1000 head)
# --------------------------------------------------------------------------

_VGG_CFG = {
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg(which):
    layers, cin, h, i = [], 3, 224, 0
    for v in _VGG_CFG[which]:
        if v == "M":
            h //= 2
            continue
        lyr, h = _conv(f"conv{i}", cin, v, 3, h)
        layers.append(lyr)
        cin, i = v, i + 1
    layers.append(ConvLayer("fc0", 512 * 7 * 7, 4096, 1, 1, 1))
    layers.append(ConvLayer("fc1", 4096, 4096, 1, 1, 1))
    layers.append(ConvLayer("fc2", 4096, 1000, 1, 1, 1))
    return layers


# --------------------------------------------------------------------------
# ResNet-34 (BasicBlock) / ResNet-50, -101 (Bottleneck)
# --------------------------------------------------------------------------

_RESNET_CFG = {  # block counts per stage; bottleneck?
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
}


def _resnet(which):
    blocks, bottleneck = _RESNET_CFG[which]
    layers = []
    lyr, h = _conv("stem", 3, 64, 7, 224, stride=2)
    layers.append(lyr)
    h //= 2  # maxpool
    cin = 64
    width = [64, 128, 256, 512]
    exp = 4 if bottleneck else 1
    for stage, nb in enumerate(blocks):
        w = width[stage]
        for b in range(nb):
            stride = 2 if (stage > 0 and b == 0) else 1
            pre = f"s{stage}b{b}"
            if bottleneck:
                lyr, _ = _conv(f"{pre}.c1", cin, w, 1, h, pad=0)
                layers.append(lyr)
                lyr, h2 = _conv(f"{pre}.c2", w, w, 3, h, stride=stride)
                layers.append(lyr)
                lyr, _ = _conv(f"{pre}.c3", w, w * 4, 1, h2, pad=0)
                layers.append(lyr)
                cout = w * 4
            else:
                lyr, h2 = _conv(f"{pre}.c1", cin, w, 3, h, stride=stride)
                layers.append(lyr)
                lyr, _ = _conv(f"{pre}.c2", w, w, 3, h2)
                layers.append(lyr)
                cout = w
            if b == 0 and (stride != 1 or cin != cout):
                lyr, _ = _conv(f"{pre}.down", cin, cout, 1, h, stride=stride, pad=0)
                layers.append(lyr)
            cin, h = cout, h2
    layers.append(ConvLayer("fc", 512 * exp, 1000, 1, 1, 1))
    return layers


# --------------------------------------------------------------------------
# DenseNet-121 / -161
# --------------------------------------------------------------------------

_DENSENET_CFG = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}


def _densenet(which):
    growth, block_cfg, init_feat = _DENSENET_CFG[which]
    layers = []
    lyr, h = _conv("stem", 3, init_feat, 7, 224, stride=2)
    layers.append(lyr)
    h //= 2  # maxpool
    cin = init_feat
    for bi, nb in enumerate(block_cfg):
        for li in range(nb):
            pre = f"b{bi}l{li}"
            lyr, _ = _conv(f"{pre}.c1", cin, 4 * growth, 1, h, pad=0)
            layers.append(lyr)
            lyr, _ = _conv(f"{pre}.c2", 4 * growth, growth, 3, h)
            layers.append(lyr)
            cin += growth
        if bi < len(block_cfg) - 1:  # transition: 1x1 halve channels + avgpool
            lyr, _ = _conv(f"t{bi}", cin, cin // 2, 1, h, pad=0)
            layers.append(lyr)
            cin //= 2
            h //= 2
    layers.append(ConvLayer("fc", cin, 1000, 1, 1, 1))
    return layers


# --------------------------------------------------------------------------
# Inception-V3 (torchvision structure, 299x299 input per the reference impl;
# the paper feeds 224 frames but Inception's canonical table is 299 — we use
# 299 and note it; MAC total ~5.7G matches literature)
# --------------------------------------------------------------------------

def _inception_branches(name, cin, h, branches):
    """branches: list of lists of (cout, k, stride, pad) chains."""
    layers = []
    out_ch = 0
    h_out = h
    for bi, chain in enumerate(branches):
        c, hh = cin, h
        for ci, (cout, k, stride, pad) in enumerate(chain):
            if isinstance(k, tuple):  # factorized 1xN / Nx1: model as two convs? given as explicit
                kh, kw = k
                ho = (hh + 2 * pad - max(kh, kw)) // stride + 1
                lyr = ConvLayer(f"{name}.b{bi}c{ci}", c, cout, int(math.sqrt(kh * kw)) if kh == kw else 1, ho, ho)
                # factorized conv: model MACs exactly via kdim override
                lyr = ConvLayer(f"{name}.b{bi}c{ci}", c * kh * kw // (1 * 1), cout, 1, ho, ho)
                hh = ho
            else:
                lyr, hh = _conv(f"{name}.b{bi}c{ci}", c, cout, k, hh, stride=stride, pad=pad)
            layers.append(lyr)
            c = cout
        out_ch += c
        h_out = hh
    return layers, out_ch, h_out


def _inception_v3():
    L = []
    lyr, h = _conv("stem0", 3, 32, 3, 299, stride=2, pad=0)
    L.append(lyr)
    lyr, h = _conv("stem1", 32, 32, 3, h, pad=0)
    L.append(lyr)
    lyr, h = _conv("stem2", 32, 64, 3, h, pad=1)
    L.append(lyr)
    h //= 2  # maxpool 3/2
    lyr, h = _conv("stem3", 64, 80, 1, h, pad=0)
    L.append(lyr)
    lyr, h = _conv("stem4", 80, 192, 3, h, pad=0)
    L.append(lyr)
    h //= 2  # maxpool 3/2 -> 35
    cin = 192

    def A(name, cin, pool_feat):
        br = [
            [(64, 1, 1, 0)],
            [(48, 1, 1, 0), (64, 5, 1, 2)],
            [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)],
            [(pool_feat, 1, 1, 0)],
        ]
        return _inception_branches(name, cin, 35, br)

    for i, pf in enumerate([32, 64, 64]):
        ls, cin, _ = A(f"mixA{i}", cin, pf)
        L += ls
    # Reduction B: 35 -> 17
    ls, c_add, h = _inception_branches(
        "redB", cin, 35,
        [[(384, 3, 2, 0)], [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)]],
    )
    L += ls
    cin = c_add + cin  # pool branch passes cin through
    h = 17

    def C(name, cin, c7):
        br = [
            [(192, 1, 1, 0)],
            [(c7, 1, 1, 0), (c7, (1, 7), 1, 3), (192, (7, 1), 1, 3)],
            [(c7, 1, 1, 0), (c7, (7, 1), 1, 3), (c7, (1, 7), 1, 3), (c7, (7, 1), 1, 3), (192, (1, 7), 1, 3)],
            [(192, 1, 1, 0)],
        ]
        return _inception_branches(name, cin, 17, br)

    for i, c7 in enumerate([128, 160, 160, 192]):
        ls, cin, _ = C(f"mixC{i}", cin, c7)
        L += ls
    # Reduction D: 17 -> 8
    ls, c_add, _ = _inception_branches(
        "redD", cin, 17,
        [[(192, 1, 1, 0), (320, 3, 2, 0)],
         [(192, 1, 1, 0), (192, (1, 7), 1, 3), (192, (7, 1), 1, 3), (192, 3, 2, 0)]],
    )
    L += ls
    cin = c_add + cin
    h = 8

    def E(name, cin):
        br = [
            [(320, 1, 1, 0)],
            [(384, 1, 1, 0), (384, (1, 3), 1, 1)],  # + (3,1) sibling below
            [(384, (3, 1), 1, 1)],
            [(448, 1, 1, 0), (384, 3, 1, 1), (384, (1, 3), 1, 1)],
            [(384, (3, 1), 1, 1)],
            [(192, 1, 1, 0)],
        ]
        # branches 2 and 4 consume intermediate 384 outputs; approximate by
        # chaining from 384 (exact MACs: in-ch 384 for the sibling convs)
        layers = []
        out_ch = 320 + 384 * 2 + 384 * 2 + 192
        for bi, chain in enumerate(br):
            c = cin if bi in (0, 1, 3, 5) else 384
            hh = 8
            for ci, (cout, k, stride, pad) in enumerate(chain):
                if isinstance(k, tuple):
                    kh, kw = k
                    layers.append(ConvLayer(f"{name}.b{bi}c{ci}", c * kh * kw, cout, 1, hh, hh))
                else:
                    lyr, hh = _conv(f"{name}.b{bi}c{ci}", c, cout, k, hh, stride=stride, pad=pad)
                    layers.append(lyr)
                c = cout
        return layers, out_ch, 8

    for i in range(2):
        ls, cin, _ = E(f"mixE{i}", cin)
        L += ls
    L.append(ConvLayer("fc", 2048, 1000, 1, 1, 1))
    return L


_BUILDERS = {
    "vgg13": lambda: _vgg("vgg13"),
    "vgg19": lambda: _vgg("vgg19"),
    "resnet34": lambda: _resnet("resnet34"),
    "resnet50": lambda: _resnet("resnet50"),
    "resnet101": lambda: _resnet("resnet101"),
    "densenet121": lambda: _densenet("densenet121"),
    "densenet161": lambda: _densenet("densenet161"),
    "inception_v3": _inception_v3,
}

NETWORKS = tuple(_BUILDERS)


def network(name: str):
    """Layer table for one of the paper's 8 benchmark CNNs."""
    return _BUILDERS[name]()


def total_macs(name: str) -> int:
    return sum(l.macs for l in network(name))


def total_weight_bytes(name: str) -> int:
    return sum(l.weight_bytes for l in network(name))
