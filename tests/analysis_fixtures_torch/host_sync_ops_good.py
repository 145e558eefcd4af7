"""Good: the sync-free forms of the same work."""
import torch


def region(x, mask, idx, n: int):  # repro: device-region
    f = torch.where(mask, x, torch.zeros_like(x))  # three-argument where: no host read
    counts = torch.zeros(n, dtype=torch.int64, device=x.device).scatter_add_(
        0, idx, torch.ones_like(idx))  # a bincount that reads nothing on the host
    i = x.repeat_interleave(2, output_size=2 * x.shape[0])
    j = x.masked_fill(~mask, 0.0)
    k = int(x.shape[0]) + len(x) + x.numel()  # shapes are host values
    return f, counts, i, j, k
