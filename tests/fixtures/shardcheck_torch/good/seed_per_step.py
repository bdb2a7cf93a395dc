"""GOOD: each step folds its index into the seed."""
import torch


def masks(steps):
    g = torch.Generator()
    out = []
    for step in range(steps):
        g.manual_seed(1234 + step)
        out.append(torch.rand(8, generator=g) > 0.5)
    return out
