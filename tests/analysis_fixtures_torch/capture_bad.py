"""Bad: host->device uploads inside a device region, each a CUDA-graph
capture break (expect RA203 x6)."""
import numpy as np
import torch

from repro_torch.kernels.backend import to_device


def region(x, rows):  # repro: device-region static[rows]
    a = torch.tensor(float(x.shape[0]), device=x.device)  # RA203
    b = torch.as_tensor(np.ones(4, np.float32), device=x.device)  # RA203
    c = to_device(rows, x.device)  # RA203
    d = torch.from_numpy(np.zeros(3)).to(x.device)  # RA203
    e = torch.ones(3).cuda()  # RA203: a tensor built on the host, then moved
    cols = [0, 2]
    f = x[:, cols]  # RA203: the list goes up as an index tensor
    return a, b, c, d, e, f
