"""GOOD: each derive domain folds its own constant."""
import torch


def epoch_seed(seed, epoch):
    return torch.Generator().manual_seed(seed * 7919 + epoch)


def job_seed(seed, job):
    return torch.Generator().manual_seed(seed * 104729 + job)
