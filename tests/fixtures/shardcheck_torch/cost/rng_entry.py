"""shardcheck SC610 fixture: an entry point that DRAWS from a generator.

Recorded by ``cost`` as ``module:rng_entry``; the fixture baselines
under ../baselines/ disagree about it on purpose: ``rng_free.json``
records it with no random op (SC610), ``rng_recorded.json`` records the
op it draws (clean)."""
import torch


def noisy(x):
    return x + torch.randn(x.shape)


def shardcheck_entry():
    return noisy, (torch.zeros(4, 4),)
