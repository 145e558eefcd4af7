"""The reads' share of the card's float32 peak: the operations every read
of the window needs (the encoder over each request's real tokens, a
document's first 512, and its search over the levels' live rows, 2 D a
row), over the window times 67 TFLOP/s (the read path runs in float32,
TF32 off). Moves ``served_rps``."""
from harness import counts
from reference.textenc import token_ids


def read(ctx):
    enc = ctx["conf"]["encoder"]
    reads = ctx["reads"]
    if not reads:
        return None
    flops = 0
    for o in reads:
        n = len(token_ids(o.text, enc["vocab_size"], enc["max_seq_len"]))
        flops += counts.encoder_flops(n, enc) + 2 * ctx["live_rows"] * enc["d_model"]
    return 100.0 * flops / (ctx["window_s"] * counts.PEAKS["fp32_flop_per_s"])
