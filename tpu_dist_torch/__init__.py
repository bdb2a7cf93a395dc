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
"""
