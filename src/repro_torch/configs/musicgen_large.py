"""musicgen-large [audio] — decoder-only over EnCodec tokens (a copy of the
reference's ``configs/musicgen_large.py`` without its training and TPU
fields).

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 per codebook, 4 codebooks
with a delay pattern. Only the transformer BACKBONE is built; the EnCodec
encoder/decoder frontend is a STUB, as in the reference: inputs are the 4
codebook token streams, which *are* the frame-token interface.
[arXiv:2306.05284; hf tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    attn_pattern=("global",),
    rope_theta=10_000.0,  # adaptation: RoPE in place of sinusoidal embeds, as in the reference
    act="gelu",
    mlp_gated=False,  # standard 2-matrix transformer FFN
    tie_embeddings=False,
    modality="audio",
    num_codebooks=4,
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
        vocab_size=64,
        num_codebooks=4,
    )
