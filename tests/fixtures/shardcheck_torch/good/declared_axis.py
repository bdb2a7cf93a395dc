"""GOOD: the axis comes from the file's mesh literal, or is canonical."""
import torch.distributed as dist

from tpu_dist_torch.parallel import mesh as mesh_lib

EXPERT_SLICE_AXIS = "expert_slice"


def build():
    return mesh_lib.make_mesh({"data": 2, EXPERT_SLICE_AXIS: 2})


def reduce_over(mesh, x):
    dist.all_reduce(x, group=mesh_lib.axis_group(mesh, EXPERT_SLICE_AXIS))
    dist.all_reduce(x, group=mesh_lib.axis_group(mesh, "data"))
    return x
