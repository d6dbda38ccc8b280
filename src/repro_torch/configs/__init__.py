"""Config registry of the port: every architecture of the JAX package.

Usage::

    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-15b")          # full published config
    cfg = get_config("starcoder2-15b-smoke")    # reduced smoke sibling
    cfg = get_config("deepseek-v2-236b-noexperts")   # MLA, dense FFN
    cfg = get_config("deepseek-v2-236b-published")   # routing, YaRN as
                                                     # published
    cfg = get_config("mamba2-1.3b")             # SSM: state rows, no KV
    cfg = get_config("seamless-m4t-large-v2")   # encoder-decoder (model only)
    cfg = get_config("llava-next-mistral-7b")   # VLM (model only)

``ARCH_IDS`` are the ten published configs the dry run sweeps (the
reference's list: neither the ``-noexperts`` stand-in nor the port's
``deepseek-v2-236b-published`` is one of them).
"""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, deepseek_v2_236b, gemma_7b,
                                 internlm2_1p8b, llava_next_mistral_7b,
                                 mamba2_1p3b, minicpm_2b,
                                 seamless_m4t_large_v2, starcoder2_15b,
                                 zamba2_1p2b)
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                      FrontendConfig, HybridConfig,
                                      InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig, YarnConfig,
                                      applicable_shapes, skipped_shapes)

REGISTRY: dict[str, ModelConfig] = {}
for _cfg in (starcoder2_15b.CONFIG, internlm2_1p8b.CONFIG, minicpm_2b.CONFIG,
             gemma_7b.CONFIG, arctic_480b.CONFIG, deepseek_v2_236b.CONFIG,
             deepseek_v2_236b.NOEXPERTS, seamless_m4t_large_v2.CONFIG,
             mamba2_1p3b.CONFIG, zamba2_1p2b.CONFIG,
             llava_next_mistral_7b.CONFIG):
    REGISTRY[_cfg.name] = _cfg
    REGISTRY[_cfg.name + "-smoke"] = _cfg.reduced()
# the port's own: DeepSeek-V2 as published (not one of the JAX package's)
REGISTRY[deepseek_v2_236b.PUBLISHED.name] = deepseek_v2_236b.PUBLISHED
REGISTRY[deepseek_v2_236b.PUBLISHED_SMOKE.name] = \
    deepseek_v2_236b.PUBLISHED_SMOKE

ARCH_IDS = [c.name for c in (
    starcoder2_15b.CONFIG, internlm2_1p8b.CONFIG, minicpm_2b.CONFIG,
    gemma_7b.CONFIG, arctic_480b.CONFIG, deepseek_v2_236b.CONFIG,
    seamless_m4t_large_v2.CONFIG, mamba2_1p3b.CONFIG, zamba2_1p2b.CONFIG,
    llava_next_mistral_7b.CONFIG)]


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; the port serves: {sorted(REGISTRY)}"
        ) from None


__all__ = ["ALL_SHAPES", "ARCH_IDS", "DECODE_32K", "FrontendConfig",
           "HybridConfig", "InputShape", "LONG_500K", "MLAConfig",
           "MoEConfig", "ModelConfig", "PREFILL_32K", "REGISTRY",
           "SHAPES_BY_NAME", "SSMConfig", "TRAIN_4K", "YarnConfig",
           "applicable_shapes",
           "get_config", "skipped_shapes"]
