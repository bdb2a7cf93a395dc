"""BAD: two seed-derivation domains fold the same constant -> SC604;
job A's epoch stream can land on job B's."""
import torch


def epoch_seed(seed, epoch):
    return torch.Generator().manual_seed(seed * 7919 + epoch)


def job_seed(seed, job):
    return torch.Generator().manual_seed(seed * 7919 + job)
