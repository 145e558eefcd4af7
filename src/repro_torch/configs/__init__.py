"""Model configurations the port supports: ``get_config("<arch-id>")``."""
from repro_torch.configs import (
    gemma2_27b,
    gemma3_4b,
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
}

# the reference's other architectures: the MoE family (llama4-scout, ROADMAP
# queue A item 10d) and MLA + MTP (deepseek-v3, item 10e)
NOT_PORTED = ("deepseek-v3-671b", "llama4-scout-17b-a16e")

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP queue A items 10d and 10e); "
            f"ported: {ARCH_NAMES}"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.CONFIG
