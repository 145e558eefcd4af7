"""zamba2-7b [hybrid] — Mamba2 backbone + alternating shared attention blocks
(a copy of the reference's ``configs/zamba2_7b.py`` without its training
and TPU fields).

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Two *shared* transformer blocks (parameters reused across applications) are
applied after every 6 Mamba2 blocks, operating at 2*d_model on
concat(hidden, original_embeddings) and projected back to d_model.
[arXiv:2411.15242; unverified tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,  # shared attn runs at 2*d_model = 7168; 7168 / 32 = 224
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=1_048_576,
    rope_theta=10_000.0,
    act="gelu",
    mlp_gated=False,  # shared-block MLP is a plain GELU FFN
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, ngroups=2, chunk_size=256),
    hybrid_period=6,
    num_shared_blocks=2,
    norm_eps=1e-5,
    loss_chunk=512,
    grad_accum=16,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=5,  # 2 hybrid groups of 2 + remainder 1
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,  # 2*d_model / num_heads = 128 / 4
        d_ff=128,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1, chunk_size=32),
        hybrid_period=2,
        num_shared_blocks=2,
        max_seq_len=512,
        loss_chunk=0,
        grad_accum=1,
    )
