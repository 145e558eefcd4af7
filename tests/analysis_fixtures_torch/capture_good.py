"""Good: uploads before the region, scalars built on the device, indexes
already there, constants cached per key."""
import functools

import torch

from repro_torch.kernels.backend import to_device


@functools.lru_cache(maxsize=16)
def lane_mask(metrics, device):
    return torch.tensor([m == "cosine" for m in metrics], device=device)  # once per key


def region(x, cols, metrics: tuple):  # repro: device-region static[metrics]
    a = torch.full((), float(x.shape[0]), device=x.device)  # built on the device
    f = x.index_select(1, cols)  # a device index
    m = lane_mask(metrics, x.device)
    y = x.to(torch.float32)  # a dtype, not a device
    return a, f, m, y


def host(rows, dev):
    d_rows = to_device(rows, dev)  # uploaded before the region
    cols = torch.as_tensor([0, 2], device=dev)
    return region(d_rows, cols, ("cosine", "dot"))
