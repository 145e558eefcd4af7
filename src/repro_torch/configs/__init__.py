"""Model configurations the port supports: ``get_config("<arch-id>")``."""
from repro_torch.configs import (
    deepseek_v3_671b,
    gemma2_27b,
    gemma3_4b,
    llama4_scout,
    llava_next_mistral_7b,
    mamba2_1_3b,
    musicgen_large,
    qwen3_8b,
    qwen15_0_5b,
    zamba2_7b,
)
from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {
    "gemma3-4b": gemma3_4b,
    "qwen1.5-0.5b": qwen15_0_5b,
    "gemma2-27b": gemma2_27b,
    "qwen3-8b": qwen3_8b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "mamba2-1.3b": mamba2_1_3b,
    "musicgen-large": musicgen_large,
    "zamba2-7b": zamba2_7b,
    "llama4-scout-17b-a16e": llama4_scout,
    "deepseek-v3-671b": deepseek_v3_671b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.CONFIG
