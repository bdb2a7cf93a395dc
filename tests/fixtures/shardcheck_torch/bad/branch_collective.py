"""BAD: only rank 0 all-reduces -> SC201: rank 1 never joins the
rendezvous and the group deadlocks."""
import torch
import torch.distributed as dist


def step(x):
    if dist.get_rank() == 0:  # shardcheck: disable=SC501 -- the recorded SC201 is this fixture's subject
        dist.all_reduce(x)
    return x


def shardcheck_entry():
    return step, (torch.ones(4),), 2
