"""Config system of the port: the reference's ``configs/base.py`` cut to the
fields the port reads.

Every architecture is one frozen ``ModelConfig``; reduced smoke variants
keep the family mechanisms at tiny widths. Every family of the reference
runs here (dense, MoE with MLA, SSM, hybrid, vision and audio) and trains
(``max_seq_len``, ``remat``, ``remat_policy``, ``loss_chunk``,
``optimizer``, ``grad_accum``, and the parameter counts ``layer_kinds``,
``total_params`` and ``active_params_per_token``). The two mesh-layout
choices the dry run reads are kept: ``infer_params_tp_only`` (inference
weights replicated over ``data``) and ``opt_pod_sharded`` (the moments
sharded over ``pod`` too). Left out are the TPU programs' knobs
(``use_pallas``, ``kernel_interpret``, ``topk_block_n``,
``topk_grid_order``, ``attn_chunk``, ``unroll``, ``gqa_repeat_kv``,
``kv_cache_dtype``): the tensor's device picks the kernel, the CUDA tiles
are compile-time constants, attention always runs the kernels and layers
are a Python loop.

``SHAPES`` are the dry run's input shapes and ``cells_for`` the shapes
each architecture runs there, as in the reference.
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
    max_seq_len: int = 131072

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

    # --- numerics and training -------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True  # recompute each layer's activations in backward
    remat_policy: str = "full"  # "full" (save nothing) | "dots" (save matmul outputs)
    infer_params_tp_only: bool = False  # replicate params over `data` at inference (no FSDP AGs)
    opt_pod_sharded: bool = False  # cross-pod ZeRO-1: shard optimizer state over `pod` too
    loss_chunk: int = 0  # chunk CE over the sequence axis; 0 = off
    optimizer: str = "adamw"  # "adamw" | "adamw8bit"
    grad_accum: int = 1  # microbatch count for train_step

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.headdim if self.ssm else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds for the whole stack."""
        if self.family in ("ssm", "hybrid"):
            return ("ssm",) * self.num_layers  # hybrid: shared attn counted apart
        return tuple(self.attn_pattern[i % len(self.attn_pattern)]
                     for i in range(self.num_layers))

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            m = self.mla
            return (d * m.q_lora_rank
                    + m.q_lora_rank * self.num_heads * m.qk_head_dim
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        return (d * self.num_heads * self.head_dim
                + 2 * d * self.num_kv_heads * self.head_dim
                + self.num_heads * self.head_dim * d)

    def active_params_per_token(self) -> int:
        """N_active for 6*N*D model-FLOPs accounting (embeddings excluded)."""
        d, n_layers = self.d_model, self.num_layers
        if self.family in ("ssm", "hybrid"):
            ssm, di = self.ssm, self.d_inner
            conv_dim = di + 2 * ssm.ngroups * ssm.d_state
            per = (d * (2 * di + 2 * ssm.ngroups * ssm.d_state + self.ssm_heads)  # in_proj
                   + conv_dim * ssm.d_conv
                   + di * d)  # out_proj
            n = n_layers * per
            if self.family == "hybrid" and self.hybrid_period:
                dm2 = 2 * d
                att = 2 * (dm2 * self.num_heads * self.head_dim
                           + dm2 * 2 * self.num_kv_heads * self.head_dim
                           + self.num_heads * self.head_dim * dm2
                           + 3 * dm2 * self.d_ff) // 2 + dm2 * d
                n += (self.num_layers // self.hybrid_period) * att
            return n
        attn = self._attn_params()
        if self.moe:
            mo = self.moe
            moe_ffn = 3 * d * mo.d_ff_expert * mo.top_k + 3 * d * mo.d_ff_shared * mo.num_shared_experts
            dense_ffn = 3 * d * (mo.d_ff_dense or self.d_ff)
            return (mo.first_k_dense * (attn + dense_ffn)
                    + (n_layers - mo.first_k_dense) * (attn + moe_ffn))
        return n_layers * (attn + 3 * d * self.d_ff)

    def total_params(self) -> int:
        """Approximate total parameter count (for memory napkin math)."""
        d, n_layers = self.d_model, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.moe:
            mo = self.moe
            per_moe = (3 * d * mo.d_ff_expert * mo.num_experts
                       + 3 * d * mo.d_ff_shared * mo.num_shared_experts
                       + d * mo.num_experts)  # router
            dense = 3 * d * (mo.d_ff_dense or self.d_ff)
            n += mo.first_k_dense * dense + (n_layers - mo.first_k_dense) * per_moe
            return n + n_layers * self._attn_params()
        return n + self.active_params_per_token()


# ---------------------------------------------------------------------------
# Input shapes of the dry run (the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# Archs allowed to run long_500k (sub-quadratic or bounded KV).
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "zamba2-7b", "gemma3-4b", "gemma2-27b")


def cells_for(arch_name: str):
    """The (shape) cells this arch runs in the dry run."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
