"""BAD: the group lookup names axis 'modle', which no mesh declares
-> SC101. The typo raises at best, reduces over the wrong group at worst."""
import torch.distributed as dist

from tpu_dist_torch.parallel import mesh as mesh_lib


def reduce_over_model(mesh, x):
    dist.all_reduce(x, group=mesh_lib.axis_group(mesh, "modle"))
    return x
