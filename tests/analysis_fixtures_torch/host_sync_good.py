"""Good: host conversions stay on the host side of the region boundary."""
import numpy as np
import torch


def program(x):  # repro: device-region
    return torch.sum(x) * 2.0


def host_side(x):
    arr = np.asarray(program(x).cpu())  # host function: syncing here is the point
    return float(arr[0]), int(arr.size)
