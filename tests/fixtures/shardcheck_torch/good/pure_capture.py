"""GOOD: the captured step stays on the device; the host reads the loss
after the call, outside the capture."""
from tpu_dist_torch.utils.graphs import CapturedProgram


def step(x):
    return (x * x).sum()


def run(specs, x):
    prog = CapturedProgram(step, specs)
    loss = prog(x=x)
    print("loss", float(loss))
