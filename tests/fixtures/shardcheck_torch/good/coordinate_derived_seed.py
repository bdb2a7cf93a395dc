"""GOOD: the seed folds the run's coordinates (epoch, rank)."""
import torch


def make_generator(base_seed, epoch, rank):
    g = torch.Generator()
    g.manual_seed(base_seed * 1_000_003 + epoch * 8 + rank)
    return g
