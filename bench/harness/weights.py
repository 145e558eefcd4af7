"""Seeded raw inputs that the benchmark makes and hands, unchanged, to the
program and to the reference: the encoder's weights, the LLM's weights
and the filler rows of the cache's levels.

Everything is drawn on the target device from a ``torch.Generator``, a
whole stacked leaf per call, in the dtype it is served in. Each use draws
from its own generator, seeded from (seed, name), so one use's draws never
shift another's.
"""
from __future__ import annotations

import hashlib
import math

import torch

F32 = torch.float32


def generator(seed: int, name: str, device) -> torch.Generator:
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(h, "little") >> 1)


def _normal(gen, shape, std, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def encoder(enc: dict, seed: int, device) -> dict:
    """A mean-pooled post-LN BERT encoder's weights, float32, ``x @ W``
    layout, in the tree ``ContrieverEncoder.load_jax_params`` reads."""
    g = generator(seed, "encoder", device)
    d, F_, n = enc["d_model"], enc["d_ff"], enc["num_layers"]
    sq = _normal(g, (n, 4, d, d), d ** -0.5, F32, device)
    wi = _normal(g, (n, d, F_), d ** -0.5, F32, device)
    wo2 = _normal(g, (n, F_, d), F_ ** -0.5, F32, device)

    def ln():
        return {"w": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    return {
        "tok_embed": _normal(g, (enc["vocab_size"], d), d ** -0.5, F32, device),
        "pos_embed": _normal(g, (enc["max_seq_len"], d), d ** -0.5, F32, device),
        "ln_embed": ln(),
        "layers": [
            {"wq": sq[i, 0], "wk": sq[i, 1], "wv": sq[i, 2], "wo": sq[i, 3], "ln1": ln(),
             "wi": wi[i], "bi": torch.zeros(F_, device=device), "wo2": wo2[i],
             "bo2": torch.zeros(d, device=device), "ln2": ln()}
            for i in range(n)
        ],
    }


def to_numpy(tree):
    """The tree with every tensor copied to a host numpy array (the form
    ``load_jax_params`` takes)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def filler(n: int, dim: int, seed: int, name: str, device) -> torch.Tensor:
    """[n, dim] float32 standard normal rows (the cache's rows that no
    request of the traffic asks for)."""
    return torch.randn((n, dim), generator=generator(seed, name, device), dtype=F32,
                       device=device)


def _mamba2_stack(g, arch, n, dt, device) -> dict:
    d, di, G, N = arch["d_model"], arch["d_inner"], arch["ngroups"], arch["d_state"]
    H, W = arch["ssm_heads"], arch["d_conv"]
    cdim = di + 2 * G * N
    u = torch.rand((n, H), generator=g, dtype=F32, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a = 1.0 + 15.0 * torch.rand((n, H), generator=g, dtype=F32, device=device)
    return {
        "ln": torch.ones((n, d), dtype=dt, device=device),
        "ssm": {
            "in_proj": _normal(g, (n, d, 2 * di + 2 * G * N + H), d ** -0.5, dt, device),
            "conv_w": _normal(g, (n, cdim, W), W ** -0.5, dt, device),
            "conv_b": torch.zeros((n, cdim), dtype=dt, device=device),
            "A_log": torch.log(a),
            "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # inverse softplus
            "D": torch.ones((n, H), dtype=F32, device=device),
            "norm_w": torch.ones((n, di), dtype=dt, device=device),
            "out_proj": _normal(g, (n, di, d), di ** -0.5, dt, device),
        },
    }


def lm(arch: dict, seed: int, device) -> dict:
    """The served LLM's weights in the served dtype (``arch["dtype"]``):
    normal draws at 1/sqrt(fan_in), ``A_log = log U[1, 16]``, ``dt_bias``
    the inverse softplus of a log-uniform draw in [1e-3, 0.1], ``D`` and
    the norms 1, biases 0."""
    g = generator(seed, "lm", device)
    dt = getattr(torch, arch["dtype"])
    d, V = arch["d_model"], arch["vocab_size"]
    params = {"embed": {"table": _normal(g, (V, d), d ** -0.5, dt, device)},
              "final_norm": torch.ones(d, dtype=dt, device=device)}
    if arch["family"] == "ssm":
        params["layers"] = _mamba2_stack(g, arch, arch["num_layers"], dt, device)
        return params
    params["mamba"] = _mamba2_stack(g, arch, arch["num_layers"], dt, device)
    n, d2, H, Dh, F_ = (arch["num_shared_blocks"], 2 * d, arch["num_heads"], arch["head_dim"],
                        arch["d_ff"])
    params["shared"] = {
        "ln1": torch.ones((n, d2), dtype=dt, device=device),
        "ln2": torch.ones((n, d2), dtype=dt, device=device),
        "attn": {k: _normal(g, (n, d2, H, Dh), d2 ** -0.5, dt, device) for k in ("wq", "wk", "wv")},
        "ffn": {"wi": _normal(g, (n, d2, F_), d2 ** -0.5, dt, device),
                "wo": _normal(g, (n, F_, d2), F_ ** -0.5, dt, device)},
        "down": _normal(g, (n, d2, d), d2 ** -0.5, dt, device),
    }
    params["shared"]["attn"]["wo"] = _normal(g, (n, H, Dh, d2), (H * Dh) ** -0.5, dt, device)
    return params
