"""A cell cut to a size a CPU test can hold: the same configuration and mix
with every width and count shrunk (the port's smoke widths, float32), for
the harness's CPU tests. Never used for a measurement."""
from __future__ import annotations

import copy

ENCODER = {"num_layers": 2, "d_model": 64, "num_heads": 4, "d_ff": 128, "vocab_size": 4096,
           "max_seq_len": 128, "smoke": True}
SERVED = {
    "ssm": {"num_layers": 3, "d_model": 64, "d_inner": 128, "ssm_heads": 4, "headdim": 32,
            "d_state": 16, "ngroups": 1, "chunk_size": 32, "vocab_size": 512},
    "hybrid": {"num_layers": 25, "d_model": 256, "d_inner": 512, "ssm_heads": 8, "headdim": 64,
               "d_state": 16, "ngroups": 2, "chunk_size": 32, "vocab_size": 512,
               "hybrid_period": 2, "num_heads": 4, "num_kv_heads": 4, "head_dim": 128,
               "d_ff": 512},
}


def shrink(spec):
    """``spec`` (a ``cell.Spec``) at smoke size."""
    spec = copy.deepcopy(spec)
    conf, mix = spec.conf, spec.mix
    conf["encoder"].update(ENCODER)
    conf["cache"].update(l1_slots=64, l2_slots=1024)
    conf["engine"].update(max_batch=4, max_seq=160, max_prompt_tokens=96)
    conf["served"].update(SERVED[conf["served"]["family"]], dtype="float32", smoke=True)
    mix.update(clusters=32, paraphrases=4, rate_rps=12.0, trace_seconds=1.0, trace_start=0.5)
    if mix.get("rag_share"):
        mix.update(rag_share=0.25, rag_words=96, check_misses=8)
    return spec
