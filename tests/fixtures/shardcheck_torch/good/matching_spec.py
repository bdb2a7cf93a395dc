"""GOOD: the spec names no more dimensions than the tensor has."""
import torch

from tpu_dist_torch.parallel.mesh import Placement


def place(mesh):
    x = torch.zeros((4, 8))
    spec = Placement(mesh, ("data", None))
    return spec.place(x)
