"""BAD: a three-entry placement spec placed on a rank-2 tensor -> SC102."""
import torch

from tpu_dist_torch.parallel.mesh import Placement


def place(mesh):
    x = torch.zeros(4, 8)
    return Placement(mesh, ("data", None, None)).place(x)
