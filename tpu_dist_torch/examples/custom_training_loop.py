"""Custom training loop: the port of the JAX package's
``examples/custom_training_loop.py``.

The reference trains through Keras ``fit``; TF users who outgrow it write
custom loops against ``strategy.run``. This program follows the JAX
package's example line for line:

* the parameters replicated with ``strategy.replicate`` (process 0's
  values on every worker), each worker's pipeline built by ``dataset_fn``
  through ``strategy.distribute_datasets_from_function``;
* the train step on ``Model.apply`` with autograd, and the gradients'
  mean across the replicas made explicit (``collectives.all_reduce``),
  where the reference's one SPMD program has XLA insert it;
* every 20 steps the per-replica losses through ``strategy.run``, reduced
  with ``strategy.reduce``.

    python -m tpu_dist_torch.examples.custom_training_loop [--device cpu]

It trains on the CUDA device unless given ``--device cpu``. Run one process
per worker with that worker's TF_CONFIG (``cluster.make_local_cluster``),
as ``examples/tpu_dist_example.py`` says, or with none for one worker.
"""

import argparse

import numpy as np
import torch

import tpu_dist_torch as td
from tpu_dist_torch.ops.losses import sparse_categorical_crossentropy
from tpu_dist_torch.parallel import collectives


def main(argv=None) -> dict:
    """Run the loop; returns each step's loss, the per-replica losses and
    their mean at every 20th step, and the final parameters (numpy, by
    dotted name)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU (default: CUDA)")
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args(argv)

    strategy = td.MultiWorkerMirroredStrategy(device=args.device)
    GLOBAL_BATCH = 8 * strategy.num_replicas_in_sync

    model = td.models.build_cnn_model()
    variables = model.init(seed=0)
    state = strategy.replicate(variables["state"])
    params = strategy.replicate(variables["params"])
    leaves = [p.requires_grad_() for p in collectives.tree_leaves(params)]
    opt = td.ops.SGD(learning_rate=0.01)
    opt_state = opt.init(leaves)

    def dataset_fn(ctx):
        ds = td.data.load("mnist", split="train", synthetic_size=4096)
        ds = ds.map(lambda x, y: (np.asarray(x, np.float32) / 255.0, y))
        return ds.shuffle(1024, seed=ctx.input_pipeline_id).batch(
            ctx.get_per_replica_batch_size(GLOBAL_BATCH)).repeat()

    def train_step(params, opt_state, x, y):
        """Forward + loss + backward + update on this replica's batch. The
        mean over the replicas' equal shards is the global batch's: the
        gradients and the loss are averaged across them explicitly."""
        logits, _ = model.apply(params, state, x, training=True)
        loss = sparse_categorical_crossentropy(
            logits, y, from_logits=True).mean()
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        collectives.all_reduce([*grads, loss], "mean")
        opt.update(grads, opt_state, leaves)
        return loss

    def replica_loss(params, x, y):
        """Runs on this replica under strategy.run: x/y are this replica's
        batch, so the vector run returns (one entry per replica) localizes
        a data problem to a worker."""
        with torch.no_grad():
            logits, _ = model.apply(params, state, x, training=False)
            return sparse_categorical_crossentropy(
                logits, y, from_logits=True).mean()

    dist = strategy.distribute_datasets_from_function(dataset_fn)
    it = iter(dist)
    out = {"losses": [], "per_replica": {}, "mean_of_replicas": {}}
    for step in range(args.steps):
        x, y = strategy.distribute_batch(next(it))
        loss = train_step(params, opt_state, x, y)
        out["losses"].append(float(loss))
        if step % 20 == 0:
            per_replica = strategy.run(replica_loss, args=(params, x, y))
            mean_of_replicas = strategy.reduce("mean", per_replica)
            out["per_replica"][step] = per_replica.tolist()
            out["mean_of_replicas"][step] = float(mean_of_replicas)
            print(f"step {step:3d}  loss {float(loss):.4f}  replicas "
                  f"{[round(v, 3) for v in per_replica.tolist()]} (mean "
                  f"{float(mean_of_replicas):.4f})")
    print("done")
    out["params"] = {
        ".".join(str(k) for k in path): t.detach().cpu().numpy()
        for path, t in _named(params)}
    return out


def _named(tree, path=()):
    """``(path, leaf)`` pairs of a nest of dicts, in sorted key order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _named(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


if __name__ == "__main__":
    main()
