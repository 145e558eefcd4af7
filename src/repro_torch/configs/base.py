"""Config system of the port: the reference's ``configs/base.py`` cut to the
fields the port reads.

Every architecture is one frozen ``ModelConfig``; reduced smoke variants
keep the family mechanisms at tiny widths. Every family of the
reference runs here (dense, MoE with MLA, SSM, hybrid, vision and audio;
the MTP head's weights, not its training-only forward), so only the fields of the reference's trainer and TPU
programs are left out; each comes back with the slice that reads it:

- ``max_seq_len``, the training knobs (``remat``, ``remat_policy``,
  ``loss_chunk``, ``optimizer``, ``grad_accum``) and the parameter counts
  (``total_params``, ``active_params_per_token``) with the training port;
- the TPU and mesh knobs (``use_pallas``, ``kernel_interpret``,
  ``topk_block_n``, ``topk_grid_order``, ``attn_chunk``, ``unroll``,
  ``infer_params_tp_only``, ``opt_pod_sharded``, ``gqa_repeat_kv``,
  ``kv_cache_dtype``) never: the tensor's device picks the kernel, the CUDA
  tiles are compile-time constants and attention always runs the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts (the reference's ``MoEConfig``)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"  # "softmax" | "sigmoid_bias" (DeepSeek aux-loss-free)
    routed_scaling: float = 1.0
    first_k_dense: int = 0  # leading dense (non-MoE) layers
    d_ff_dense: int = 0  # d_ff of those leading dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention widths (the reference's ``MLAConfig``)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block widths (the reference's ``SSMConfig``)."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention pattern -------------------------------------------------
    # cycled over layers; entries: "global" | "local" | "nope_global"
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 0  # sliding window for "local" layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0  # 0 => same as rope_theta
    query_scale: float = 0.0  # 0 => 1/sqrt(head_dim)
    post_norms: bool = False  # gemma-style pre+post block norms
    act: str = "silu"  # "silu" | "gelu"
    mlp_gated: bool = True  # gated (SwiGLU/GeGLU) vs plain 2-matrix MLP
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)

    # --- family sub-configs --------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # --- hybrid (zamba2) ------------------------------------------------------
    hybrid_period: int = 0  # apply a shared attn block after every N ssm blocks
    num_shared_blocks: int = 0  # alternating shared attention blocks

    # --- modality frontends (stubs, as in the reference) ----------------------
    modality: str = "text"  # text | vision | audio
    num_codebooks: int = 0  # musicgen: EnCodec codebooks
    vision_patches: int = 0  # llava stub: number of patch embeddings per image
    d_frontend: int = 0  # dim of stub frontend embeddings

    # --- multi-token prediction (deepseek-v3) ---------------------------------
    mtp_depth: int = 0

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.headdim if self.ssm else 0
