"""BAD: a captured step prints and reads the loss on the host -> SC103.
Both run once, at capture, and never on replay."""
from tpu_dist_torch.utils.graphs import CapturedProgram


def step(x):
    loss = (x * x).sum()
    print("loss", loss.item())
    return loss


def program(specs):
    return CapturedProgram(step, specs)
