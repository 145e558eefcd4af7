"""Operations and bytes that the work needs, from the inputs' shapes alone,
and the card's published peaks: the yardstick of every roofline and MFU
share. Each input byte counts once and each output byte once, only live
rows and real tokens count, so the same work counts the same whatever
implements it.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flop_per_s": 67e12,  # FP32 outside the tensor cores (TF32 off)
    "bf16_flop_per_s": 989e12,  # bf16 tensor cores
}


def bound_s(nbytes: float, flops: float, flop_rate: float) -> Tuple[float, str]:
    """The least time the card needs: the larger of bytes over HBM
    bandwidth and operations over the peak rate, and which one it is."""
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = flops / flop_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def similarity_topk_bound(Q: int, live_rows: int, dim: int, lanes: int, k: int) -> float:
    """B1 over the live rows of every lane for Q real queries: rows and
    queries read once, k (score, index) pairs a lane written per query,
    2 D FLOP per (query, live row), at the FP32 rate."""
    nbytes = 4 * live_rows * dim + 4 * Q * dim + 8 * Q * lanes * k
    return bound_s(nbytes, 2.0 * Q * live_rows * dim, PEAKS["fp32_flop_per_s"])[0]


def flash_bound(B, S, H, KH, Dh, window, Dv=None) -> float:
    """Causal prefill attention: q, k, v read once and o written once
    (bf16), against 2 (Dh + Dv) FLOP per (query, key) pair a query attends
    to."""
    Dv = Dv or Dh
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    return bound_s(2 * (B * S * H * (Dh + Dv) + B * S * KH * (Dh + Dv)),
                   2 * B * H * (Dh + Dv) * pairs, PEAKS["bf16_flop_per_s"])[0]


def decode_bound(B, H, KH, Dh, window, lens) -> float:
    """One decode step's attention: the live K/V rows read once, q read and
    o written once, the lengths, against 4 Dh FLOP per (query head, live
    row)."""
    rows = sum(min(n, window) if window else n for n in lens)
    return bound_s(2 * rows * KH * Dh * 2 + 2 * B * H * Dh * 2 + B * 4,
                   4 * H * Dh * rows, PEAKS["bf16_flop_per_s"])[0]


def ssd_flops(S, H, G, P, N, L) -> int:
    """One scan at batch 1, counting the causal half of each chunk's
    [L, L] products: C B^T once per group (over N); per head the
    inter-chunk term and the state update (2 L P N each), its scores times
    x (the causal pairs, over P) and the skip term."""
    total = 0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        total += G * N * lc * (lc + 1) + H * (4 * lc * P * N + P * lc * (lc + 1) + 2 * lc * P)
    return total


def ssd_bound(S, H, G, P, N, L) -> float:
    """B5 at batch 1 in bf16: x in, y out, B/C, dt (float32), A and D, the
    float32 final state out; the products at the bf16 tensor-core rate."""
    nbytes = 2 * S * H * P * 2 + 2 * S * G * N * 2 + S * H * 4 + 2 * H * 4 + H * P * N * 4
    return bound_s(nbytes, ssd_flops(S, H, G, P, N, min(L, S)), PEAKS["bf16_flop_per_s"])[0]


def encoder_flops(n_tokens: int, enc: dict) -> int:
    """One text of ``n_tokens`` real tokens through the encoder: the four
    attention projections, the FFN, and the scores and their mix over the
    n^2 token pairs, per layer."""
    d, F_ = enc["d_model"], enc["d_ff"]
    per_layer = 2 * n_tokens * (4 * d * d + 2 * d * F_) + 4 * n_tokens * n_tokens * d
    return enc["num_layers"] * per_layer


def _mixer_linear_flops(arch: dict) -> int:
    d, di, G, N, H = (arch["d_model"], arch["d_inner"], arch["ngroups"], arch["d_state"],
                      arch["ssm_heads"])
    cdim = di + 2 * G * N
    return 2 * d * (2 * di + 2 * G * N + H) + 2 * di * d + 2 * cdim * arch["d_conv"]


def _shared_linear_flops(arch: dict) -> int:
    d2, H, Dh, F_ = 2 * arch["d_model"], arch["num_heads"], arch["head_dim"], arch["d_ff"]
    return 2 * d2 * 3 * H * Dh + 2 * H * Dh * d2 + 2 * 2 * d2 * F_ + 2 * d2 * arch["d_model"]


def _groups(arch: dict) -> int:
    return arch["num_layers"] // arch["hybrid_period"] if arch["family"] == "hybrid" else 0


def lm_prefill_flops(arch: dict, S: int) -> int:
    """A prompt of S tokens: every layer's products per token, the scans
    (``ssd_flops`` per Mamba2 layer), the shared blocks' causal attention
    pairs, and the logits of the last position only (as served)."""
    P, N, H, G = arch["headdim"], arch["d_state"], arch["ssm_heads"], arch["ngroups"]
    total = S * arch["num_layers"] * _mixer_linear_flops(arch)
    total += arch["num_layers"] * ssd_flops(S, H, G, P, N, min(arch["chunk_size"], S))
    g = _groups(arch)
    if g:
        pairs = S * (S + 1) // 2
        total += g * (S * _shared_linear_flops(arch)
                      + 4 * arch["num_heads"] * arch["head_dim"] * pairs)
    return total + 2 * arch["d_model"] * arch["vocab_size"]


def lm_decode_flops(arch: dict, context: int) -> int:
    """One generated token whose cache holds ``context`` positions: every
    layer's products, the recurrent state update and read (4 P N a head),
    the attention over the context, and the logits."""
    P, N, H = arch["headdim"], arch["d_state"], arch["ssm_heads"]
    total = arch["num_layers"] * (_mixer_linear_flops(arch) + 4 * H * P * N)
    g = _groups(arch)
    if g:
        total += g * (_shared_linear_flops(arch)
                      + 4 * arch["num_heads"] * arch["head_dim"] * (context + 1))
    return total + 2 * arch["d_model"] * arch["vocab_size"]
