"""tpu_dist_torch — the PyTorch/CUDA port of ``tpu_dist``.

Each module keeps the path and name of its counterpart in ``tpu_dist`` so a
reader can find the reference. The package imports ``torch``, numpy and the
standard library only: never ``jax`` and never ``tpu_dist``.

Entry points (``serve.engine.ServeEngine``, ``python -m
tpu_dist_torch.serve``, ``Sequential.compile`` before ``fit`` /
``make_train_function``) run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without that argument they raise (see
``utils/device.py``). Every kernel that ``tpu_dist`` wrote in Pallas for the
TPU is a hand-written Hopper kernel here, under ``csrc/``, beside a plain
PyTorch version of the same function that CPU tensors take.

The reference program ports line for line
(``python -m tpu_dist_torch.examples.tpu_dist_example [--device cpu]``)::

    import tpu_dist_torch as td

    strategy = td.MultiWorkerMirroredStrategy(td.CollectiveCommunication.AUTO)
    dataset = (td.data.load("mnist", split="train")
               .map(scale).cache().shuffle(10000).batch(GLOBAL_BATCH_SIZE))
    options = td.data.Options()
    options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.OFF
    with strategy.scope():
        model = td.models.build_and_compile_cnn_model(learning_rate=0.001)
    model.fit(dataset.with_options(options), epochs=10, steps_per_epoch=20)
"""

from tpu_dist_torch import (cluster, data, models, observe, ops, parallel,
                            training, utils)
from tpu_dist_torch.cluster import ClusterConfig, barrier, initialize, is_chief
from tpu_dist_torch.data import AutoShardPolicy, Dataset, Options
from tpu_dist_torch.models import (Model, Sequential,
                                   build_and_compile_cnn_model)
from tpu_dist_torch.parallel import (CollectiveCommunication, InputContext,
                                     MirroredStrategy,
                                     MultiWorkerMirroredStrategy,
                                     ParameterServerStrategy, ReduceOp,
                                     Strategy, get_strategy)
from tpu_dist_torch.training import (Callback, EarlyStopping, History,
                                     JSONLogger, LambdaCallback,
                                     ModelCheckpoint, TensorBoard,
                                     checkpoint)

__version__ = "0.1.0"

__all__ = [
    "cluster", "data", "models", "observe", "ops", "parallel", "training",
    "utils",
    "ClusterConfig", "barrier", "initialize", "is_chief",
    "AutoShardPolicy", "Dataset", "Options",
    "Model", "Sequential", "build_and_compile_cnn_model",
    "CollectiveCommunication", "InputContext", "MirroredStrategy",
    "MultiWorkerMirroredStrategy", "ParameterServerStrategy", "ReduceOp",
    "Strategy", "get_strategy",
    "Callback", "EarlyStopping", "History", "JSONLogger", "LambdaCallback",
    "ModelCheckpoint", "TensorBoard", "checkpoint",
    "__version__",
]
