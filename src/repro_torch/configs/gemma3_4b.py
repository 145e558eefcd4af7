"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k context
(a copy of the reference's ``configs/gemma3_4b.py`` without its training
and TPU fields).

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
[hf:google/gemma-3-4b-pt family; unverified tier per assignment]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    post_norms=True,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=6,  # one full local:global pattern cycle
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window_size=16,
    )
