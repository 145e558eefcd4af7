"""The served language models, restated in float32 plain PyTorch: Mamba2
(SSD, arXiv:2405.21060) and Zamba2's hybrid of Mamba2 blocks with shared
attention blocks (arXiv:2411.15242), as the served configuration states
them.

Weights are the benchmark's dict of tensors (``harness.weights.lm``), in
the layout the program is handed: ``embed.table`` [V, d] (tied),
``final_norm`` and a Mamba2 stack (``layers`` for the SSM family,
``mamba`` for the hybrid) with ``ln`` and ``ssm`` {``in_proj``, ``conv_w``,
``conv_b``, ``A_log``, ``dt_bias``, ``D``, ``norm_w``, ``out_proj``}
stacked over layers; the hybrid adds ``shared`` (per shared block ``ln1``,
``attn`` {``wq`` ``wk`` ``wv`` [2d, H, Dh], ``wo`` [H, Dh, 2d]}, ``ln2``,
``ffn`` {``wi``, ``wo``}, ``down`` [2d, d]).

Each matrix passes through ``cast`` before use: float32 for the
reference, a lower precision's rounding for the control.
"""
from __future__ import annotations

import hashlib
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
Cast = Callable[[torch.Tensor], torch.Tensor]


def to_f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(F32)


def fp8_rounded(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale per output column (the
    last axis), returned in float32: the control's weights."""
    w = w.to(F32)
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (w * scale).to(torch.float8_e4m3fn).to(F32) / scale


def prompt_ids(prompt: str, vocab: int, length: int) -> List[int]:
    """The served prompt's token ids: one id per whitespace-separated word
    (``blake2b-32(word) mod vocab``), at most ``length``, front-padded with
    id 7 to exactly ``length``."""
    words = prompt.split()[:length] or ["empty"]
    ids = [int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "little") % vocab
           for w in words]
    return [7] * (length - len(ids)) + ids


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def _silu(x):
    return x * torch.sigmoid(x)


def ssd(x, dt, A, Bm, Cm, chunk: int = 256):
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t, from a zero state, computed a chunk at a time.
    x [B, S, H, P], dt [B, S, H], A [H], Bm/Cm [B, S, G, N] (head h reads
    group h // (H / G)) -> y [B, S, H, P]."""
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = Cm.repeat_interleave(rep, dim=2)
    state = x.new_zeros((Bsz, H, P, Bm.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        a = dt[:, sl] * A  # [B, l, H]
        cum = torch.cumsum(a, dim=1)
        l_ = a.shape[1]
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # [B, t, s, H]
        causal = torch.ones((l_, l_), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None], float("-inf")))
        cb = torch.einsum("bthn,bshn->btsh", Ch[:, sl], Bh[:, sl])
        w = cb * decay * dt[:, sl][:, None]
        y = torch.einsum("btsh,bshp->bthp", w, x[:, sl])
        y = y + torch.einsum("bthn,bhpn->bthp", Ch[:, sl], state) * torch.exp(cum)[..., None]
        ys.append(y)
        ws = torch.exp(cum[:, -1:] - cum) * dt[:, sl]
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bsh,bshn,bshp->bhpn", ws, Bh[:, sl], x[:, sl]))
    return torch.cat(ys, dim=1)


def mamba2_mixer(p, arch, x, cast: Cast):
    """One Mamba2 mixer on x [B, S, d] (float32)."""
    di, G, N = arch["d_inner"], arch["ngroups"], arch["d_state"]
    H, P, W = arch["ssm_heads"], arch["headdim"], arch["d_conv"]
    zxbcdt = x @ cast(p["in_proj"])
    z, xbc, dt_raw = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * G * N], zxbcdt[..., 2 * di + 2 * G * N:]
    S = x.shape[1]
    conv = F.conv1d(xbc.transpose(1, 2), cast(p["conv_w"])[:, None, :], p["conv_b"].to(F32),
                    padding=W - 1, groups=xbc.shape[-1])[..., :S]
    xbc = _silu(conv.transpose(1, 2))
    xs = xbc[..., :di].reshape(*x.shape[:2], H, P)
    Bm = xbc[..., di:di + G * N].reshape(*x.shape[:2], G, N)
    Cm = xbc[..., di + G * N:].reshape(*x.shape[:2], G, N)
    dt = F.softplus(dt_raw + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    y = ssd(xs, dt, A, Bm, Cm) + p["D"].to(F32)[:, None] * xs
    y = y.reshape(*x.shape[:2], di) * _silu(z)
    return rms_norm(y, p["norm_w"], arch["norm_eps"]) @ cast(p["out_proj"])


def _rope(x, positions, theta):
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * inv  # [S, half]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale, block: int = 1024):
    """softmax(q k^T * scale) v over the causal pairs; q/k/v [B, S, H, D]."""
    Bsz, S, H, D = q.shape
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)  # [B, H, D, S]
    vt = v.transpose(1, 2)  # [B, H, S, D]
    for b in range(Bsz):
        for s0 in range(0, S, block):
            qs = q[b, s0:s0 + block].transpose(0, 1)  # [H, l, D]
            sc = (qs @ kt[b]) * scale  # [H, l, S]
            rows = torch.arange(s0, s0 + qs.shape[1], device=q.device)[:, None]
            sc = sc.masked_fill(torch.arange(S, device=q.device)[None] > rows, float("-inf"))
            out[b, s0:s0 + block] = (torch.softmax(sc, dim=-1) @ vt[b]).transpose(0, 1)
    return out


def shared_block(p, arch, x, x0, cast: Cast):
    """Zamba2's shared attention block at 2 d on concat(x, x0), projected
    back to d and added to x."""
    inp = torch.cat([x, x0], dim=-1)
    H, Dh = arch["num_heads"], arch["head_dim"]
    h = rms_norm(inp, p["ln1"], arch["norm_eps"])
    pos = torch.arange(x.shape[1], device=x.device)
    proj = lambda w: (h @ cast(w).reshape(w.shape[0], -1)).reshape(*h.shape[:2], H, Dh)  # noqa: E731
    q = _rope(proj(p["attn"]["wq"]), pos, arch["rope_theta"])
    k = _rope(proj(p["attn"]["wk"]), pos, arch["rope_theta"])
    o = causal_attention(q, k, proj(p["attn"]["wv"]), Dh ** -0.5)
    wo = cast(p["attn"]["wo"])
    r = inp + o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    h2 = rms_norm(r, p["ln2"], arch["norm_eps"])
    r = r + F.gelu(h2 @ cast(p["ffn"]["wi"]), approximate="tanh") @ cast(p["ffn"]["wo"])
    return x + r @ cast(p["down"])


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@torch.no_grad()
def logits_at(params, arch, tokens: torch.Tensor, positions: Sequence[int],
              cast: Cast = to_f32) -> torch.Tensor:
    """float32 logits [B, len(positions), V] of the full forward pass over
    ``tokens`` [B, S], at the given positions."""
    x = params["embed"]["table"][tokens].to(F32)
    mixer = lambda lp, x: x + mamba2_mixer(lp["ssm"], arch, rms_norm(x, lp["ln"], arch["norm_eps"]), cast)  # noqa: E731
    if arch["family"] == "ssm":
        for i in range(arch["num_layers"]):
            x = mixer(_layer(params["layers"], i), x)
    else:
        x0, period = x, arch["hybrid_period"]
        groups = arch["num_layers"] // period
        for g in range(groups):
            for i in range(g * period, (g + 1) * period):
                x = mixer(_layer(params["mamba"], i), x)
            x = shared_block(_layer(params["shared"], g % arch["num_shared_blocks"]), arch,
                             x, x0, cast)
        for i in range(groups * period, arch["num_layers"]):
            x = mixer(_layer(params["mamba"], i), x)
    h = rms_norm(x[:, list(positions)], params["final_norm"], arch["norm_eps"])
    return h @ cast(params["embed"]["table"]).T
