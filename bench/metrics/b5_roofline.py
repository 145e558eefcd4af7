"""B5 (``kernels/ssd_scan``, once a Mamba2 layer a prefill) against its
roofline in the traced sub-window: the calls launched there (the kernel's
launch counter) at the served prompt length and the model's widths
(``counts.ssd_bound``), over B5's device time in the trace. Moves
``served_rps`` (a miss answered sooner resolves inside the window)."""
from harness import counts


def read(ctx):
    calls, t = ctx["sub"].get("launch", {}).get("b5", 0), ctx["trace"].family_s.get("b5", 0.0)
    if not calls or t <= 0:
        return None
    a, S = ctx["conf"]["served"], ctx["conf"]["engine"]["max_prompt_tokens"]
    bound = counts.ssd_bound(S, a["ssm_heads"], a["ngroups"], a["headdim"], a["d_state"],
                             a["chunk_size"])
    return 100.0 * calls * bound / t
