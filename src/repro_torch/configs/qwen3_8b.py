"""qwen3-8b [dense] — GQA kv=8 with per-head RMS qk-norm (a copy of the
reference's ``configs/qwen3_8b.py`` without its training and TPU fields).

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
[hf:Qwen/Qwen3-8B; hf tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    attn_pattern=("global",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
    )
