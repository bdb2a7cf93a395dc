"""BAD: the generator is re-seeded with the same value every step
-> SC602: every step draws the same dropout mask."""
import torch


def masks(steps):
    g = torch.Generator()
    out = []
    for _ in range(steps):
        g.manual_seed(1234)
        out.append(torch.rand(8, generator=g) > 0.5)
    return out
