"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free (a copy of
the reference's ``configs/mamba2_1_3b.py`` without its training fields).

48L d_model=2048 vocab=50280, ssm_state=128.
[arXiv:2405.21060; unverified tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,  # d_inner / headdim = 4096 / 64
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    max_seq_len=1_048_576,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1, chunk_size=256),
    norm_eps=1e-5,
    tie_embeddings=True,
    loss_chunk=512,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        head_dim=16,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1, chunk_size=32),
        max_seq_len=512,
        loss_chunk=0,
    )
