"""The engine's share of the card's bf16 peak: the operations the window's
prefills (the prompt tokens the engine counted by the window's close) and
generated tokens (those of the misses answered in the window, each at its
context length) need for the served model's shapes
(``counts.lm_prefill_flops`` / ``lm_decode_flops``), over the window times
989 TFLOP/s.
Moves ``served_rps`` (a miss answered sooner resolves inside the window)."""
from harness import counts


def read(ctx):
    arch, S = ctx["conf"]["served"], ctx["conf"]["engine"]["max_prompt_tokens"]
    prefills = ctx["engine"].get("prefill_tokens", 0) / S
    end = ctx["win"].t0 + ctx["window_s"]
    gen = [o for o in ctx["gens"] if o.done <= end]
    if not prefills and not gen:
        return None
    flops = prefills * counts.lm_prefill_flops(arch, S)
    for o in gen:
        n = len((o.response.text or "").split())
        flops += sum(counts.lm_decode_flops(arch, S + j) for j in range(n - 1))
    return 100.0 * flops / (ctx["window_s"] * counts.PEAKS["bf16_flop_per_s"])
