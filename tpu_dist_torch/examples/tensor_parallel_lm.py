"""Hybrid data x tensor parallel training of the transformer LM: the port
of the JAX package's ``examples/tensor_parallel_lm.py``.

Add a ``'model'`` axis to the strategy's mesh and the same
``compile``/``fit`` program shards the attention and MLP parameters
Megatron-style across its processes (``parallel/tensor.py``):
column-parallel QKV and MLP up-projection, row-parallel output
projections, a column-parallel vocab head gathered before the loss. The
strategy's ``axis_shapes`` is the whole opt-in.

What to look at after ``fit``: each process holds ``1 / M`` of ``wq``'s
columns (and Adam's moments of them); the losses are the replicated run's
(``tests/test_torch_tensor_parallel.py`` holds them to the JAX package's
fit on the same mesh).

    python -m tpu_dist_torch.examples.tensor_parallel_lm [--device cpu]
        [--model-axis M]

Run one process per worker with that worker's TF_CONFIG
(``cluster.make_local_cluster``), as ``examples/custom_training_loop.py``
says; the workers form a ``{'data': -1, 'model': M}`` mesh (``M``
default 2), so their number must be a multiple of ``M``. With one process
and ``--model-axis 1`` it trains unsharded. It trains on the CUDA device
unless given ``--device cpu``.
"""

import argparse

import numpy as np

import tpu_dist_torch as td
from tpu_dist_torch.models.transformer import build_transformer_lm


def main(argv=None) -> dict:
    """Train; returns the History's losses and ``wq``'s global and local
    shapes."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU (default: CUDA)")
    parser.add_argument("--model-axis", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)

    # data(-1) x model(M): batches shard over the data axis, every layer's
    # heads and hidden units over the model axis.
    strategy = td.MultiWorkerMirroredStrategy(
        axis_shapes={"data": -1, "model": args.model_axis},
        device=args.device, communication="ring")
    with strategy.scope():
        model = build_transformer_lm(args.vocab, args.seq_len,
                                     d_model=args.d_model, depth=2,
                                     num_heads=8)
        model.compile(
            loss=td.ops.SparseCategoricalCrossentropy(from_logits=True),
            optimizer=td.ops.Adam(1e-3), metrics=["accuracy"])

    # Synthetic next-token data (any td.data pipeline works here).
    seq = args.seq_len
    rng = np.random.default_rng(0)
    stream = rng.integers(0, args.vocab, size=4096 + seq + 1).astype(np.int64)
    xs = np.stack([stream[i:i + seq] for i in range(0, 4096, 32)])
    ys = np.stack([stream[i + 1:i + seq + 1] for i in range(0, 4096, 32)])
    ds = td.data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
    history = model.fit(ds, epochs=args.epochs, steps_per_epoch=args.steps,
                        verbose=1 if td.cluster.is_chief() else 0)

    local = model.variables["params"]["block"]["residual"]["main"][
        "multiheadattention"]["wq"]
    hd = 8 * (args.d_model // 8)
    print(f"wq: global {(args.d_model, hd)}, per-process shard "
          f"{tuple(local.shape)} on a {dict(strategy.mesh.shape)} mesh")
    return {"loss": history.history["loss"],
            "wq_global": [args.d_model, hd], "wq_local": list(local.shape)}


if __name__ == "__main__":
    main()
