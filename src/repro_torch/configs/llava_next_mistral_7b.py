"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling (a copy of
the reference's ``configs/llava_next_mistral_7b.py`` without its training
and TPU fields).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The modality frontend is a STUB, as in the reference: the caller provides
precomputed patch embeddings [B, num_patches, d_frontend]; the model owns
the 2-layer MLP projector into the backbone width.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified tier]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=32768,
    attn_pattern=("global",),
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    modality="vision",
    vision_patches=2880,  # anyres: 5 tiles x 576 patches (24x24 @ CLIP-L/14, 336px)
    d_frontend=1024,  # CLIP ViT-L/14 hidden size
    loss_chunk=512,
    grad_accum=4,
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
        vision_patches=8,
        d_frontend=32,
        max_seq_len=512,
        loss_chunk=0,
        grad_accum=1,
    )
