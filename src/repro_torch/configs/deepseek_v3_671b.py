"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP (a
copy of the reference's ``configs/deepseek_v3_671b.py`` without its training
and TPU fields).

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
[arXiv:2412.19437; hf tier]
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,  # qk head dim (128 nope + 64 rope); v_head_dim = 128
    d_ff=18432,  # dense-layer FFN width (first 3 layers)
    vocab_size=129280,
    attn_pattern=("global",),
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        capacity_factor=1.25,
        router="sigmoid_bias",  # aux-loss-free load balancing
        routed_scaling=2.5,
        first_k_dense=3,
        d_ff_dense=18432,
    ),
    mtp_depth=1,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=4,  # 1 dense + 3 MoE
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=192,
        vocab_size=512,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            d_ff_expert=64,
            num_shared_experts=1,
            d_ff_shared=64,
            capacity_factor=1.5,
            router="sigmoid_bias",
            routed_scaling=2.5,
            first_k_dense=1,
            d_ff_dense=192,
        ),
        mtp_depth=1,
    )
