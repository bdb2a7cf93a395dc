"""Expert-parallel Mixture-of-Experts LM on a data x expert mesh: the port
of the JAX package's ``examples/moe_expert_parallel_lm.py``.

A Switch-transformer LM whose FFN experts shard over the ``expert`` axis,
tokens travelling to their experts and back by two ``all_to_all``
exchanges (``parallel/expert.py``). The router's load-balance auxiliary
loss joins the training objective through the trainer.

    python -m tpu_dist_torch.examples.moe_expert_parallel_lm [--device cpu]
        [--expert-axis P]

Run one process per worker with that worker's TF_CONFIG
(``cluster.make_local_cluster``), as ``examples/custom_training_loop.py``
says; the workers form a ``{'data': -1, 'expert': P}`` mesh (``P``
default 2). It trains on the CUDA device unless given ``--device cpu``.
"""

import argparse

import numpy as np

import tpu_dist_torch as td
from tpu_dist_torch.models.transformer import build_transformer_lm


def main(argv=None) -> dict:
    """Train; returns the losses, an expert leaf's local shape and the
    auxiliary losses."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU (default: CUDA)")
    parser.add_argument("--expert-axis", type=int, default=2)
    parser.add_argument("--experts", type=int, default=8)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)

    strategy = td.MultiWorkerMirroredStrategy(
        axis_shapes={"data": -1, "expert": args.expert_axis},
        device=args.device, communication="ring")
    with strategy.scope():
        model = build_transformer_lm(
            args.vocab, args.seq_len, d_model=args.d_model, depth=2,
            num_heads=8, ff_dim=2 * args.d_model, moe_experts=args.experts,
            moe_top_k=2, moe_groups=8)
        model.compile(
            loss=td.ops.SparseCategoricalCrossentropy(from_logits=True),
            optimizer=td.ops.Adam(1e-3), metrics=["accuracy"])

    seq = args.seq_len
    stream = (np.arange(20_000) * 2654435761) % args.vocab
    xs = np.stack([stream[i:i + seq] for i in range(0, 16_000, 40)])
    ys = np.stack([stream[i + 1:i + seq + 1] for i in range(0, 16_000, 40)])
    ds = td.data.Dataset.from_tensor_slices(
        (xs.astype(np.int64), ys.astype(np.int64))).batch(32).repeat()
    history = model.fit(ds, epochs=args.epochs, steps_per_epoch=args.steps,
                        verbose=1 if td.cluster.is_chief() else 0)
    w1 = next(p for n, p in model.named_parameters() if n.endswith(".w1"))
    aux = [float(b) for n, b in model.named_buffers()
           if n.endswith("aux_loss")]
    print(f"expert stack w1: {args.experts} experts, this process's "
          f"{tuple(w1.shape)} on a {dict(strategy.mesh.shape)} mesh; "
          f"load-balance aux losses (in the objective) "
          f"{[round(a, 5) for a in aux]}")
    return {"loss": history.history["loss"], "w1_local": list(w1.shape),
            "aux": aux}


if __name__ == "__main__":
    main()
