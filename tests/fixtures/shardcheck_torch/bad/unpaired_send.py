"""BAD: rank 0 sends 16 floats, rank 1 receives 8 -> SC203: a short
recv is a hang or a torn buffer on real hardware."""
import torch
import torch.distributed as dist


def step():
    if dist.get_rank() == 0:
        dist.send(torch.ones(16), 1)
    else:
        buf = torch.empty(8)
        dist.recv(buf, 0)


def shardcheck_entry():
    return step, (), 2
