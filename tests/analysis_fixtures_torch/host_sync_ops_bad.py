"""Bad: every other RA101 form inside a device region (expect RA101 x11)."""
import torch

from repro_torch.kernels.backend import fetch


def region(x, mask, idx):  # repro: device-region
    a = x.tolist()  # RA101
    b = x.cpu()  # RA101
    c = x.to("cpu")  # RA101
    torch.cuda.synchronize()  # RA101
    (d,) = fetch(x)  # RA101
    e = torch.nonzero(mask)  # RA101: output sized by the data
    f = torch.where(mask)  # RA101: one-argument where is nonzero
    g = x.masked_select(mask)  # RA101
    h = torch.unique(idx)  # RA101
    i = idx.repeat_interleave(idx)  # RA101: no output_size
    j = x[x > 0]  # RA101: boolean mask index
    return a, b, c, d, e, f, g, h, i, j
