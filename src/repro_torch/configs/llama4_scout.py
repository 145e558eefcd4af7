"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion (a copy of the reference's ``configs/llama4_scout.py`` without its
training and TPU fields).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
Attention: 3 chunked-local (8192) layers : 1 global NoPE layer.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_pattern=("local", "local", "local", "nope_global"),
    window_size=8192,  # chunked attention approximated as sliding window
    qk_norm=True,
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
        capacity_factor=1.25,
        router="softmax",
    ),
    loss_chunk=512,
    grad_accum=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=4,  # one local/local/local/nope_global cycle
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window_size=16,
        moe=MoEConfig(
            num_experts=4,
            top_k=1,
            d_ff_expert=128,
            num_shared_experts=1,
            d_ff_shared=128,
            capacity_factor=1.5,
            router="softmax",
        ),
        max_seq_len=512,
        loss_chunk=0,
        grad_accum=1,
    )
