"""Config registry of the port: the architectures it serves so far.

Usage::

    from repro_torch.configs import get_config
    cfg = get_config("internlm2-1.8b")          # full published config
    cfg = get_config("internlm2-1.8b-smoke")    # reduced smoke sibling
    cfg = get_config("deepseek-v2-236b-noexperts")   # MLA, dense FFN
"""
from __future__ import annotations

from repro_torch.configs import deepseek_v2_236b, internlm2_1p8b
from repro_torch.configs.base import MLAConfig, ModelConfig

REGISTRY: dict[str, ModelConfig] = {}
for _m in (internlm2_1p8b, deepseek_v2_236b):
    REGISTRY[_m.CONFIG.name] = _m.CONFIG
    REGISTRY[_m.CONFIG.name + "-smoke"] = _m.CONFIG.reduced()


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; the port serves: {sorted(REGISTRY)}"
        ) from None


__all__ = ["MLAConfig", "ModelConfig", "REGISTRY", "get_config"]
