"""GOOD: the first result is cloned before the program runs again."""
from tpu_dist_torch.utils.graphs import CapturedProgram


def step(x):
    return (x * x).sum()


def two_losses(specs, a, b):
    prog = CapturedProgram(step, specs)
    first = prog(x=a).clone()
    second = prog(x=b)
    return first, second
