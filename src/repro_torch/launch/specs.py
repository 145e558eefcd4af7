"""Shape-only stand-ins for every model input of the dry run (the port of
the reference's ``launch/specs.py``).

``input_specs(cfg, shape)`` returns allocation-free ``meta`` tensors and
their spec trees for the step a cell runs: the train step (train_*),
prefill (prefill_*) or one decode step (decode_* / long_*).
``abstract_params`` / ``abstract_cache`` build the real constructors on
``meta`` (``init_params`` / ``init_cache`` with ``device="meta"``), so the
dry run's shapes can never drift from the real ones; the spec trees are
``param_specs`` / ``cache_specs``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import BATCH
from repro_torch.models import transformer as T

META = torch.device("meta")
I32 = torch.int32
BF16 = torch.bfloat16


def abstract_params(cfg: ModelConfig) -> Tuple[Any, Any]:
    return T.init_params(cfg, device=META), T.param_specs(cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> Tuple[Any, Any]:
    return T.init_cache(cfg, batch, max_seq, device=META), T.cache_specs(cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, batch: int, seq: int) -> Tuple[Dict, Dict]:
    """(abstract batch dict, batch specs dict) for the given token count."""
    if cfg.modality == "audio":
        return ({"tokens": _meta((batch, cfg.num_codebooks, seq), I32)},
                {"tokens": (BATCH, None, None)})
    if cfg.modality == "vision":
        text = max(seq - cfg.vision_patches, 16)
        return (
            {"tokens": _meta((batch, text), I32),
             "vision_embeds": _meta((batch, cfg.vision_patches, cfg.d_frontend), BF16)},
            {"tokens": (BATCH, None), "vision_embeds": (BATCH, None, None)},
        )
    return {"tokens": _meta((batch, seq), I32)}, {"tokens": (BATCH, None)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Everything ``dryrun.lower_cell`` needs to run one (arch x shape) cell."""
    if shape.kind == "train":
        batch, batch_specs = _token_batch(cfg, shape.global_batch, shape.seq_len)
        return {"kind": "train", "batch": batch, "batch_specs": batch_specs}

    if shape.kind == "prefill":
        batch, batch_specs = _token_batch(cfg, shape.global_batch, shape.seq_len)
        cache, cache_specs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        return {"kind": "prefill", "batch": batch, "batch_specs": batch_specs,
                "cache": cache, "cache_specs": cache_specs}

    # decode: one new token against a seq_len-deep cache
    B = shape.global_batch
    if cfg.modality == "audio":
        tokens, tok_spec = _meta((B, cfg.num_codebooks, 1), I32), (BATCH, None, None)
    else:
        tokens, tok_spec = _meta((B, 1), I32), (BATCH, None)
    cache, cache_specs = abstract_cache(cfg, B, shape.seq_len)
    return {"kind": "decode", "tokens": tokens, "tokens_spec": tok_spec,
            "pos": _meta((B,), I32), "pos_spec": (BATCH,),
            "cache": cache, "cache_specs": cache_specs}
