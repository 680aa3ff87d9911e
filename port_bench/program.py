"""What the benchmark takes from the program besides its entry points: the
configuration's ``ModelConfig`` and the build of the CUDA sources a
configuration names (``src/repro_torch/_build``, inside the checkout)."""

from __future__ import annotations


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    m = dict(cfg["model"])
    if m.get("ssm"):
        m["ssm"] = SSMConfig(**m["ssm"])
    return ModelConfig(**m)


def build_kernels(cfg: dict, device) -> list:
    """Build (or find built) the CUDA sources the configuration runs; the
    names of those built now."""
    if device.type != "cuda":
        return []
    from repro_torch.kernels import _build

    return _build.build_all(tuple(cfg["kernels"]))
