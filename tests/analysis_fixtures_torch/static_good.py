"""Good: the Python values of device regions — constants, static[...]
parameters, annotated host types, shapes, `is None`, membership in a
pytree, and a cached factory's constants (expect nothing)."""
import functools

import numpy as np
import torch


def free(bank, lanes, idxs):  # repro: device-region
    at = (lanes, idxs)
    bank.created[at] = 0.0
    bank.expires[at] = float("inf")  # a constant


def search(buf, valid, q, k: int, metrics: tuple):  # repro: device-region static[k]
    if len(set(metrics)) == 1:  # an annotated tuple
        s = q @ buf.T
    else:
        s = torch.stack([q @ b.T for b in buf])
    s = s.masked_fill(~valid, float("-inf"))
    return torch.sort(s, descending=True, stable=True)[0][..., :k]


def scatter(bank, idxs, rows, *, normalize: bool):  # repro: device-region
    if normalize:  # an annotated bool
        rows = rows / rows.norm(dim=-1, keepdim=True)
    bank.buf[idxs] = rows


# repro: device-region static[causal, window, softcap, scale]
def launch(lib, q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap are >= 0")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    err = lib.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), int(bool(causal)),
                     int(window), float(softcap), float(scale))
    return err


@functools.lru_cache(maxsize=64)
def make_decide(specs, device):
    def const(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)  # once per key

    t = const([s for s in specs], torch.float32)

    def decide(s):  # repro: device-region
        return s > t

    return decide


# repro: device-region static[specs, lifecycle, tick, now]
def run(bank, forward, args, specs, use_kernel: bool, lifecycle, tick, now):
    q = forward(*args)
    valid = bank.valid
    if lifecycle:
        valid = valid & (bank.expires > now)
    s = search(bank.buf, valid, q, 4, ("cosine",)) if use_kernel else q
    if lifecycle:
        s = s - now
    return make_decide(specs, s.device)(s), tick + 1


def decode_step(params, cfg, tokens, pos, cache):  # repro: device-region static[cfg]
    if cfg.embed_scale:  # a config field
        tokens = tokens * 2
    if cfg.modality == "vision" and "vision_embeds" in cache:  # membership in a pytree
        tokens = tokens + 1
    return params["w"][tokens] + pos


class ScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, chunk):  # repro: device-region static[chunk]
        ctx.chunk = chunk
        return x * chunk

    @staticmethod
    def backward(ctx, dy, dstate):
        if dy is None:
            dy = torch.zeros(1)
        if dstate is not None:
            dy = dy + dstate
        return dy * ctx.chunk, None
