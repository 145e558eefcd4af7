"""Good: absolute stamps stay float64; float32 carries relative offsets."""
import time

import torch

_EPOCH = time.time()


def stamps(created_rel, expires_rel, x):
    a = torch.tensor(time.time(), dtype=torch.float64)  # absolute: float64
    b = torch.full((4,), created_rel, dtype=torch.float32)  # relative seconds
    c = expires_rel.to(torch.float32)
    d = x.float()
    return a, b, c, d
