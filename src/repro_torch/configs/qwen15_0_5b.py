"""qwen1.5-0.5b [dense] — MHA with QKV bias (a copy of the reference's
``configs/qwen15_0_5b.py``).

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B; hf tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
    )
