"""B4 (``kernels/flash_attention``, once a shared-block application a
prefill) against its roofline in the traced sub-window: the calls launched
there (the kernel's launch counter), each a causal prefill at the served
prompt length and the shared block's heads (``counts.flash_bound``), over
B4's device time in the trace.
Moves ``served_rps`` (a miss answered sooner resolves inside the window)."""
from harness import counts


def read(ctx):
    calls, t = ctx["sub"].get("launch", {}).get("b4", 0), ctx["trace"].family_s.get("b4", 0.0)
    if not calls or t <= 0:
        return None
    a, S = ctx["conf"]["served"], ctx["conf"]["engine"]["max_prompt_tokens"]
    bound = counts.flash_bound(1, S, a["num_heads"], a["num_kv_heads"], a["head_dim"], 0)
    return 100.0 * calls * bound / t
