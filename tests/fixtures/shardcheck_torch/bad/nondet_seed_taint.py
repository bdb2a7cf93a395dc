"""BAD: the generator is seeded from the wall clock -> SC601. Replay
draws another stream."""
import time

import torch


def make_generator():
    seed = int(time.time())
    g = torch.Generator()
    g.manual_seed(seed)
    return g
