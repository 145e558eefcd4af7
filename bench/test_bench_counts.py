"""The benchmark's operation and byte counts against hand counts."""
import math

from harness import counts

HBM, FP32, BF16 = (counts.PEAKS[k] for k in ("hbm_bytes_per_s", "fp32_flop_per_s",
                                              "bf16_flop_per_s"))


def test_similarity_topk_bound_by_hand():
    # Q=2 queries, 10 live rows, D=4, 2 lanes, k=3: rows 160 B, queries 32 B,
    # outputs 2*2*3 pairs of 8 B = 96 B; 2*2*10*4 = 160 FLOP
    got = counts.similarity_topk_bound(2, 10, 4, 2, 3)
    assert math.isclose(got, max(288 / HBM, 160 / FP32))
    # at Q = 64 over ~958k rows of 768 the products bound it
    big = counts.similarity_topk_bound(64, 958_463, 768, 2, 4)
    assert math.isclose(big, 2 * 64 * 958_463 * 768 / FP32)


def test_flash_bound_by_hand():
    # S=3 causal: 1 + 2 + 3 = 6 pairs; 2 * (Dh + Dv) = 8 FLOP a pair
    # bytes: q, k, v, o at 2 B: 2 * (3*1*4 + 3*1*4) = 48
    assert math.isclose(counts.flash_bound(1, 3, 1, 1, 2, 0), max(48 / HBM, 48 / BF16))
    # a window of 2 caps the third query at 2 pairs: 5 pairs
    assert math.isclose(counts.flash_bound(1, 3, 1, 1, 2, 2), max(48 / HBM, 40 / BF16))


def test_decode_bound_by_hand():
    # lengths 3 and 1, KH=1, Dh=2: k/v 4 rows * 2 * 2 * 2 B = 32; q/o 2 * 2 * 1 * 2 * 2 = 16;
    # lengths 8 B; FLOP 4 * 1 * 2 * 4 = 32
    assert math.isclose(counts.decode_bound(2, 1, 1, 2, 0, (3, 1)), max(56 / HBM, 32 / BF16))


def test_ssd_flops_by_hand():
    # S=3, chunk 2: chunk of 2: G N l (l+1) = 6, H (4 l P N + P l (l+1) + 2 l P) = 8 + 6 + 4
    # chunk of 1: 2 + (4 + 2 + 2)
    assert counts.ssd_flops(3, 1, 1, 1, 1, 2) == 6 + 18 + 2 + 8


def test_encoder_flops_by_hand():
    enc = {"d_model": 2, "d_ff": 4, "num_layers": 3}
    # per layer: 2 n (4 d^2 + 2 d F) + 4 n^2 d at n = 2: 4 * (16 + 16) + 32
    assert counts.encoder_flops(2, enc) == 3 * 160


ARCH = {"family": "hybrid", "num_layers": 3, "hybrid_period": 2, "num_shared_blocks": 2,
        "d_model": 2, "d_inner": 4, "ngroups": 1, "d_state": 2, "ssm_heads": 2, "headdim": 2,
        "d_conv": 4, "chunk_size": 2, "num_heads": 1, "head_dim": 4, "d_ff": 8,
        "vocab_size": 10}


def test_lm_flops_by_hand():
    # mixer products a token: in_proj 2*2*(8+4+2)=56, out_proj 2*4*2=16, conv 2*8*4=64
    mixer = 56 + 16 + 64
    # shared block at 2d=4: q/k/v 2*4*3*4=96, o 2*4*4=32, FFN 2*2*4*8=128, down 2*4*2=16
    shared = 96 + 32 + 128 + 16
    logits = 2 * 2 * 10
    # decode at context 5: 3 mixers + state 4*H*P*N = 32 each, 1 group with 4*H*Dh*6 attention
    assert counts.lm_decode_flops(ARCH, 5) == 3 * (mixer + 32) + (shared + 4 * 4 * 6) + logits
    # prefill of S=2: products per token, one scan per layer, 3 causal pairs, one logits row
    scan = counts.ssd_flops(2, 2, 1, 2, 2, 2)
    assert counts.lm_prefill_flops(ARCH, 2) == (2 * 3 * mixer + 3 * scan
                                                + (2 * shared + 4 * 4 * 3) + logits)


def test_ssd_bound_reads_each_input_once():
    S, H, G, P, N, L = 4096, 112, 2, 64, 64, 256
    nbytes = 2 * S * H * P * 2 + 2 * S * G * N * 2 + S * H * 4 + 2 * H * 4 + H * P * N * 4
    want = max(nbytes / HBM, counts.ssd_flops(S, H, G, P, N, L) / BF16)
    assert math.isclose(counts.ssd_bound(S, H, G, P, N, L), want)
