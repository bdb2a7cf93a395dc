"""BAD: the first call's result is read after the program ran again
-> SC104. A captured program's outputs are static buffers that each
replay overwrites: `first` now holds the second batch's loss."""
from tpu_dist_torch.utils.graphs import CapturedProgram


def step(x):
    return (x * x).sum()


def two_losses(specs, a, b):
    prog = CapturedProgram(step, specs)
    first = prog(x=a)
    second = prog(x=b)
    return first, second
