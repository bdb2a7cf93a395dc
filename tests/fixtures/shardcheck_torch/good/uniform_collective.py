"""GOOD: every rank all-reduces the same shape, a fixed number of times,
and the ring's sends meet their recvs."""
import torch
import torch.distributed as dist


def step(x):
    for _ in range(3):
        dist.all_reduce(x)
    rank, world = dist.get_rank(), dist.get_world_size()
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
           dist.P2POp(dist.irecv, buf, (rank - 1) % world)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf


def shardcheck_entry():
    return step, (torch.ones(4),), 2
