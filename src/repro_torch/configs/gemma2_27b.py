"""gemma2-27b [dense] — local+global alternating attention, logit softcapping
(a copy of the reference's ``configs/gemma2_27b.py`` without its training
and TPU fields).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
[arXiv:2408.00118; hf tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_pattern=("local", "global"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0 ** -0.5,  # query_pre_attn_scalar = d_model / num_heads = 144
    rope_theta=10_000.0,
    post_norms=True,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=4,  # two local:global cycles
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        window_size=16,
        query_scale=16.0 ** -0.5,
    )
