"""Model configurations the port supports: ``get_config("<arch-id>")``."""
from repro_torch.configs import mamba2_1_3b, qwen15_0_5b
from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {"qwen1.5-0.5b": qwen15_0_5b, "mamba2-1.3b": mamba2_1_3b}

# the reference's other architectures: their families (MoE, MLA, hybrid,
# audio, vision) and configs are ROADMAP queue A item 10
NOT_PORTED = (
    "gemma3-4b", "gemma2-27b", "qwen3-8b", "deepseek-v3-671b", "llama4-scout-17b-a16e",
    "llava-next-mistral-7b", "musicgen-large", "zamba2-7b",
)

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP queue A item 10); ported: {ARCH_NAMES}"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.CONFIG
