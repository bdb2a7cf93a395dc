"""BAD: a collective inside a loop whose trip count the data decides
-> SC202: ranks whose data differ launch different counts."""
import torch
import torch.distributed as dist


def step():
    x = torch.randn(8) * 10
    while float(x.abs().max()) > 1.0:
        dist.all_reduce(x)
        x = x / 2
    return x


def shardcheck_entry():
    return step, (), 2
