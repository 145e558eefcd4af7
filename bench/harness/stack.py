"""The system under test, built through the port's public API from the
benchmark's raw inputs: the encoder, a two-level generative cache on one
kernel-path bank, the LLM's engine behind ``ModelBackend``, and the
``CacheService`` in front (``repro_torch`` only).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np


@dataclass
class Stack:
    encoder: Any
    hierarchy: Any
    bank: Any
    engine: Any
    backend: Any
    client: Any
    service: Any


def port_lm_config(served: dict):
    """The port's configuration of the served LLM (``served["port_config"]``
    names the module under ``repro_torch.configs``), checked against the
    configuration file's numbers; a smoke-sized file overrides widths."""
    mod = importlib.import_module(f"repro_torch.configs.{served['port_config']}")
    cfg = mod.CONFIG
    over = {k: served[k] for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                   "head_dim", "d_ff", "vocab_size", "hybrid_period",
                                   "num_shared_blocks", "norm_eps", "rope_theta")
            if k in served and hasattr(cfg, k)}
    ssm = dataclasses.replace(cfg.ssm, d_state=served["d_state"], d_conv=served["d_conv"],
                              expand=served["d_inner"] // served["d_model"],
                              headdim=served["headdim"], ngroups=served["ngroups"],
                              chunk_size=served["chunk_size"])
    cfg2 = dataclasses.replace(cfg, ssm=ssm, dtype=served["dtype"], **over)
    if served.get("smoke"):
        return cfg2
    if cfg2 != cfg:
        raise ValueError(f"{cfg.name}: the configuration file does not state the port's "
                         f"configuration: {cfg2} != {cfg}")
    return cfg


def port_encoder_config(enc: dict):
    from repro_torch.configs.contriever import CONTRIEVER_MSMARCO, EncoderConfig

    cfg = EncoderConfig(name=enc["name"], num_layers=enc["num_layers"], d_model=enc["d_model"],
                        num_heads=enc["num_heads"], d_ff=enc["d_ff"],
                        vocab_size=enc["vocab_size"], max_seq_len=enc["max_seq_len"],
                        norm_eps=enc["norm_eps"])
    if not enc.get("smoke") and cfg != CONTRIEVER_MSMARCO:
        raise ValueError(f"the encoder file does not state contriever-msmarco: {cfg}")
    return cfg


def build(conf: dict, enc_weights: dict, fill_l1: np.ndarray, fill_l2: np.ndarray,
          cached: List[Tuple[str, str]], knobs: Tuple[float, float, float], lm_params: dict,
          device) -> Stack:
    """Build and fill the system: L1 and L2 ``GenerativeCache`` levels (L2
    holds the filler rows, then ``cached`` through the encoder; L1 its
    filler rows), stacked into one bank; the engine over ``lm_params``;
    the client and the service. Promotion into L1 and the write-back of
    synthesised answers are off, so the window's reads leave the levels'
    entries as set-up left them (see PERF.md)."""
    from repro_torch.core import ContrieverEncoder, EnhancedClient, GenerativeCache, HierarchicalCache
    from repro_torch.serving.engine import ModelBackend, ServingEngine
    from repro_torch.serving.service import CacheService

    cache, svc, eng, served = conf["cache"], conf["service"], conf["engine"], conf["served"]
    enc = ContrieverEncoder(port_encoder_config(conf["encoder"]), device=device)
    enc.load_jax_params(enc_weights)
    t_s, t_single, t_comb = knobs

    def level(cap):
        return GenerativeCache(enc, threshold=t_s, t_single=t_single, t_combined=t_comb,
                               capacity=cap, max_sources=cache["max_sources"], use_pallas=True,
                               cache_synthesized=False, device=device)

    l1, l2 = level(cache["l1_slots"]), level(cache["l2_slots"])
    for lvl, rows, tag in ((l1, fill_l1, "l1"), (l2, fill_l2, "l2")):
        n = len(rows)
        lvl.insert_batch([f"filler {tag} {i}" for i in range(n)],
                         [f"filler answer {tag} {i}" for i in range(n)], vecs=rows)
    l2.insert_batch([q for q, _ in cached], [a for _, a in cached])  # through the encoder
    h = HierarchicalCache(l1, l2, promote=False)
    bank = h.ensure_bank()
    want = (2, cache["l2_slots"], enc.dim)
    if bank is None or tuple(bank.buf.shape) != want or not bank.use_pallas:
        raise RuntimeError(f"expected one {list(want)} kernel-path bank, got {bank}")
    engine = ServingEngine(port_lm_config(served), params=lm_params, max_batch=eng["max_batch"],
                           max_seq=eng["max_seq"], device=device)
    backend = ModelBackend(served["port_config"], engine,
                           max_prompt_tokens=eng["max_prompt_tokens"])
    client = EnhancedClient(cache=l1, hierarchy=h)
    client.register_backend(backend)
    service = CacheService(client, max_batch=svc["max_batch"], max_wait_ms=svc["max_wait_ms"],
                           dispatch_batch=svc["dispatch_batch"])
    return Stack(enc, h, bank, engine, backend, client, service)
