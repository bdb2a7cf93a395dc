"""shardcheck cost fixture: one all-reduce of a float32 [16, 8] over a
4-rank group, whose ring cost is 2 * (4 - 1) / 4 * 512 = 768 bytes a
rank. Recorded by ``cost`` as ``module:cost_entry``."""
import torch
import torch.distributed as dist


def step(x):
    dist.all_reduce(x)
    return x * 2


def shardcheck_entry():
    return step, (torch.ones(16, 8),), 4
