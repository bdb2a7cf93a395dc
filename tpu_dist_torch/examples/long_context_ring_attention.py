"""Long-context attention with ring attention (sequence parallelism): the
port of the JAX package's ``examples/long_context_ring_attention.py``.

A context too long to attend on one device is split along the sequence
over a ``seq`` mesh axis, and ``ring_attention_blocks`` computes exact
attention on each process's block by rotating the K/V blocks around the
axis's processes while an online softmax merges them
(``parallel/sequence.py``). No process holds the ``[L, L]`` scores or the
whole K/V. It composes with data parallelism on the same mesh.

    python -m tpu_dist_torch.examples.long_context_ring_attention
        [--device cpu] [--seq-len L]

Run one process per worker with that worker's TF_CONFIG
(``cluster.make_local_cluster``), as ``examples/custom_training_loop.py``
says; the workers form a ``{'data': 2, 'seq': -1}`` mesh when their
number is even and above 2, else ``{'data': 1, 'seq': -1}``. It runs on
the CUDA device unless given ``--device cpu``.
"""

import argparse
import math

import numpy as np
import torch

import tpu_dist_torch as td
from tpu_dist_torch.parallel import sequence_sharding
from tpu_dist_torch.parallel.mesh import coordinate
from tpu_dist_torch.parallel.sequence import ring_attention_blocks


def main(argv=None) -> dict:
    """Attend; returns the block's shape and the largest error against
    dense attention over the first positions."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: CUDA)")
    parser.add_argument("--seq-len", type=int, default=4096)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--head-dim", type=int, default=64)
    parser.add_argument("--check", type=int, default=256,
                        help="positions of the dense spot check")
    args = parser.parse_args(argv)

    n = td.cluster.process_count()
    data = 2 if n > 2 and n % 2 == 0 else 1
    strategy = td.MultiWorkerMirroredStrategy(
        axis_shapes={"data": data, "seq": -1}, device=args.device,
        communication="ring")
    mesh = strategy.mesh
    b, h, ln, d = 2, args.heads, args.seq_len, args.head_dim
    print(f"mesh: {dict(mesh.shape)}  per-process context: "
          f"{ln // mesh.shape['seq']} of {ln} tokens")

    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(b, h, ln, d)).astype(np.float32)
               for _ in range(3))
    # Each process holds its block of the sequence (and its rows).
    placement = sequence_sharding(mesh, batch_axis="data")
    ql, kl, vl = (placement.place(x) for x in (q, k, v))
    out = ring_attention_blocks(ql, kl, vl, mesh=mesh, axis_name="seq",
                                causal=True, batch_axis="data")
    print(f"ring attention over {ln} tokens: this process's block "
          f"{tuple(out.shape)}")

    # Exactness spot check against dense attention on the first positions,
    # which the process at seq coordinate 0 holds.
    err = None
    if coordinate(mesh, "seq") == 0:
        ls = min(args.check, out.shape[2])
        rows = placement_rows(mesh, b)
        qs, ks, vs = (torch.from_numpy(x[rows, :, :ls]) for x in (q, k, v))
        s = qs @ ks.transpose(-1, -2) / math.sqrt(d)
        s = s.masked_fill(torch.ones(ls, ls, dtype=torch.bool).triu(1),
                          -math.inf)
        dense = torch.softmax(s, -1) @ vs
        err = float((out[:, :, :ls].cpu() - dense).abs().max())
        print(f"max |ring - dense| over the first {ls} tokens: {err:.2e}")
        assert err < 3e-5
    return {"block": list(out.shape), "max_abs_err": err}


def placement_rows(mesh, batch: int) -> slice:
    """This process's rows of a batch split over the data axis."""
    per = batch // mesh.shape["data"]
    start = coordinate(mesh, "data") * per
    return slice(start, start + per)


if __name__ == "__main__":
    main()
