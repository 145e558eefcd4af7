"""Bad: host syncs reachable from a device region (expect RA101 x3)."""
import numpy as np
import torch


def helper(x):
    return float(x[0])  # RA101 via call-graph reachability


def program(x):  # repro: device-region
    y = torch.sum(x)
    z = y.item()  # RA101: blocking device->host sync
    w = np.asarray(y)  # RA101: materializes on host mid-region
    return z + helper(x) + w
