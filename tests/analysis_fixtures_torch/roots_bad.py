"""Bad: regions found without a marker — an autograd Function, an
nn.Module's forward, a callable captured under torch.cuda.graph and one
passed to make_graphed_callables (expect RA101 x3, RA202 x1)."""
import torch
from torch import nn


class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * x.sum().item()  # RA101

    @staticmethod
    def backward(ctx, dy):
        return dy


class Block(nn.Module):
    def forward(self, x):
        if x.mean() > 0:  # RA202
            x = x + 1
        return x


def step(x):
    return x.tolist()  # RA101


def graphed(x):
    return float(x)  # RA101


def capture(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x)
    h = torch.cuda.make_graphed_callables(graphed, (x,))
    return y, h
