"""Hybrid data x pipeline parallel training of the transformer LM: the port
of the JAX package's ``examples/pipeline_parallel_lm.py``.

Add a ``'pipe'`` axis to the strategy's mesh and ask the model builder for
``pipeline_stages``: the same ``compile``/``fit`` program GPipe-pipelines
the transformer blocks (``parallel/pipeline_parallel.py``). Each process
holds one stage's weights, a batch is split into microbatches, and every
schedule tick hands activations to the next stage. Then the 1F1B step
(``parallel/pipeline_1f1b.py``) trains the same model in a custom loop
with O(S) activation memory.

What to look at: ``pipelinedblocks.stages.*`` leaves are ``[1, ...]`` on
each process (the ``[S, ...]`` stack split over 'pipe'); the losses are
the pipe-less run's (``tests/test_torch_pipeline_parallel.py`` holds them
to the JAX package's).

    python -m tpu_dist_torch.examples.pipeline_parallel_lm [--device cpu]
        [--stages S]

Run one process per worker with that worker's TF_CONFIG
(``cluster.make_local_cluster``), as ``examples/custom_training_loop.py``
says; the workers form a ``{'data': -1, 'pipe': S}`` mesh (``S`` default
2), so their number must be a multiple of ``S``. It trains on the CUDA
device unless given ``--device cpu``.
"""

import argparse

import numpy as np
import torch

import tpu_dist_torch as td
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.parallel import make_1f1b_train_step


def main(argv=None) -> dict:
    """Train with fit (GPipe), then with the 1F1B step; returns both runs'
    losses and a stage leaf's global and local shapes."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU (default: CUDA)")
    parser.add_argument("--stages", type=int, default=2)
    parser.add_argument("--microbatches", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)

    strategy = td.MultiWorkerMirroredStrategy(
        axis_shapes={"data": -1, "pipe": args.stages}, device=args.device,
        communication="ring")
    with strategy.scope():
        model = build_transformer_lm(
            args.vocab, args.seq_len, d_model=args.d_model,
            depth=args.depth, num_heads=8, pipeline_stages=args.stages,
            pipeline_microbatches=args.microbatches)
        model.compile(
            loss=td.ops.SparseCategoricalCrossentropy(from_logits=True),
            optimizer=td.ops.Adam(1e-3), metrics=["accuracy"])

    # A deterministic synthetic next-token stream.
    seq = args.seq_len
    stream = (np.arange(20_000) * 2654435761) % args.vocab
    xs = np.stack([stream[i:i + seq] for i in range(0, 16_000, 40)])
    ys = np.stack([stream[i + 1:i + seq + 1] for i in range(0, 16_000, 40)])
    xs, ys = xs.astype(np.int64), ys.astype(np.int64)
    ds = td.data.Dataset.from_tensor_slices((xs, ys)).batch(32).repeat()
    history = model.fit(ds, epochs=args.epochs, steps_per_epoch=args.steps,
                        verbose=1 if td.cluster.is_chief() else 0)
    name = next(n for n, _ in model.named_parameters() if ".stages." in n)
    local = dict(model.named_parameters())[name]
    print(f"{name}: [{args.stages}, ...] stacked, this process's stage "
          f"{tuple(local.shape)} on a {dict(strategy.mesh.shape)} mesh")

    # 1F1B: the memory-bounded schedule as a custom loop on the same mesh,
    # the same parameters.
    step = make_1f1b_train_step(
        model, td.ops.SparseCategoricalCrossentropy(from_logits=True),
        strategy=strategy)
    opt = td.ops.SGD(0.01)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    opt_state = opt.init(params)
    device = params[0].device
    losses = []
    for i in range(args.steps):
        rows = slice(32 * i, 32 * (i + 1))
        loss, grads = step(torch.from_numpy(xs[rows]).to(device),
                           torch.from_numpy(ys[rows]).to(device))
        opt.update([grads[n] for n in names], opt_state, params)
        losses.append(float(loss))
    print(f"1F1B losses {[round(v, 4) for v in losses]}; stash slots "
          f"{step.stats['slots']}, most inputs held {step.stats['max_live']}")
    return {"loss": history.history["loss"], "loss_1f1b": losses,
            "stage_local": list(local.shape), "stats": dict(step.stats)}


if __name__ == "__main__":
    main()
