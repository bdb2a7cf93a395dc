"""Line-for-line port of the reference's tf_dist_example.py onto the port.

The same program as ``examples/tpu_dist_example.py`` of the JAX package:
TF_CONFIG, then ``MultiWorkerMirroredStrategy``, then ``data.load("mnist")``
with map / cache / shuffle / batch, then ``AutoShardPolicy.OFF``, then the
CNN built and compiled in the strategy's scope, then ``fit`` for 10
epochs of 20 steps at a batch of 64 per worker.

    python -m tpu_dist_torch.examples.tpu_dist_example [--device cpu]

It trains on the CUDA device unless given ``--device cpu``. Run one process
per worker with that worker's TF_CONFIG (one worker per card on CUDA, any
number on the CPU, where the workers all-reduce over gloo), or with no
TF_CONFIG for one worker:

    # worker 0 (also the chief)
    TF_CONFIG='{"cluster":{"worker":["10.0.0.1:12345","10.0.0.2:12345"]},
                "task":{"type":"worker","index":0}}' \\
        python -m tpu_dist_torch.examples.tpu_dist_example
    # worker 1
    TF_CONFIG='{"cluster":{"worker":["10.0.0.1:12345","10.0.0.2:12345"]},
                "task":{"type":"worker","index":1}}' \\
        python -m tpu_dist_torch.examples.tpu_dist_example
"""

import argparse

import numpy as np

import tpu_dist_torch as td

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: CUDA)")
args = parser.parse_args()

# -- Strategy (reference tf_dist_example.py:12-13) ---------------------------
strategy = td.MultiWorkerMirroredStrategy(
    td.CollectiveCommunication.AUTO, device=args.device)
# strategy = td.MirroredStrategy()   # single-host alternative

td.data.disable_progress_bar()            # reference tf_dist_example.py:15
BUFFER_SIZE = 10000                       # reference tf_dist_example.py:16-18
NUM_WORKERS = max(td.cluster.process_count(), 1)
GLOBAL_BATCH_SIZE = 64 * NUM_WORKERS


# -- Dataset (reference tf_dist_example.py:15-37) ----------------------------
def make_datasets_unbatched():
    def scale(image, label):
        image = np.asarray(image, np.float32) / 255.0
        return image, label

    datasets, info = td.data.load(with_info=True,
                                  name="mnist",
                                  as_supervised=True)

    return datasets["train"].map(scale).cache().shuffle(BUFFER_SIZE)


train_datasets = make_datasets_unbatched().batch(GLOBAL_BATCH_SIZE)
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.OFF
train_datasets_no_auto_shard = train_datasets.with_options(options)


# -- Model (reference tf_dist_example.py:39-53) ------------------------------
def build_and_compile_cnn_model():
    return td.models.build_and_compile_cnn_model(learning_rate=0.001)


# -- Scoped build + fit (reference tf_dist_example.py:56-59) -----------------
with strategy.scope():
    multi_worker_model = build_and_compile_cnn_model()

history = multi_worker_model.fit(x=train_datasets_no_auto_shard, epochs=10,
                                 steps_per_epoch=20)
