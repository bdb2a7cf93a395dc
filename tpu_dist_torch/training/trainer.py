"""The training engine: the train step and the Keras-2-style fit loop.

Subset of ``tpu_dist/training/trainer.py``, one device per process. The
JAX package compiles the whole step (forward, loss, backward, update, metrics) into
one XLA program whose variables are donated and returned; PyTorch runs the
same step eagerly and keeps its variables in place:

JAX package                           | here
--------------------------------------|-----------------------------------
``jax.value_and_grad`` of the loss    | ``loss.backward()``; the flash
                                      | attention's backward is the
                                      | hand-written kernel pair
``optimizer.update`` returns new      | ``optimizer.update`` changes params
params and state                      | and state in place (``no_grad``)
metric / loss-accumulator pytrees     | 0-d device tensors added to in place
returned by the step                  |
the step returns a 7-tuple of loss,   | the step returns the loss tensor;
new variables and the health vector   | no host sync until someone reads it

The model trains on the device its parameters are on (``compile`` puts
them there, on the scoped strategy's device). Under a strategy with more
than one replica (``MultiWorkerMirroredStrategy`` over several processes)
the trainer broadcasts process 0's initial parameters, and each step
all-reduces the gradients and the loss as one flat buffer (the mean over
the processes, the reference's single end-of-step all-reduce) before the
optimizer update; the epoch's loss and metric totals are reduced before
they are read, so the History is the same on every process and is the
global batch's. A mean of per-process means is the global batch's mean
only for equal shards: DATA sharding slices every global batch into equal
parts (and raises on a batch the process count does not divide); under
OFF every process brings its own equally sized local batch.

Under a mesh with a ``model`` or ``seq`` axis beside the data axis
(``parallel/tensor.py``, ``parallel/sequence.py``) the replicas are the
data axis's processes: every reduction above runs over this process's
data-axis group (``Strategy.data_group``), so a shard of a
tensor-parallel leaf is averaged only with the same shard on its data
peers, and the processes beside it on the other axis, which hold the same
rows, compute the same loss. Such a step's forward and backward hold
collectives, so it runs eagerly (no captured program).

``compile(gradient_bucket_bytes=b > 0)`` switches a multi-process step to
the JAX package's bucketed schedule (``_pure_step_bucketed``): each
process's BatchNorm takes its own shard's moments (no synchronisation in
the forward or the backward), the loss is averaged across the processes,
the gradients go through ``collectives.bucketed_all_reduce`` in
reverse-order buckets of about ``b`` bytes over the JAX package's flatten
order of the parameter tree (sorted names), and after the update the
running state is averaged across the processes, as the JAX package
``pmean``s its new state. The default schedule (``b = 0``) synchronises
BatchNorm's moments over the global batch instead. The buckets are reduced
after the backward pass has ended; overlapping them with it is ROADMAP's
K8.

``fit``/``evaluate`` take a ``DeviceDataset``, a ``Dataset``, a
``DistributedDataset`` or ``(x, y)`` arrays (batches of 32 in order),
taken in the JAX package's ``_distribute`` order; anything else raises
``TypeError``. A ``Dataset`` is first offered to the promotion to a
device-resident ``DeviceDataset`` (``data/vectorize.py``: one process, a
device other than the CPU, a chain of the promotion's grammar): its
arrays cross to the card once and each step gathers its batch there from
an index vector. The port promotes the reference program's own chain on
the synthetic MNIST, where the JAX package's scale detection declines its
``x / 255`` and keeps it on the host path (``_detect_scale``). Otherwise the chain is rewritten where it can be: a uint8
batch crosses to the device and its scale (the dataset's
``device_transform``) runs inside the step, and so inside a captured
execution too. ``prefetch_to_device = d`` places the host pipeline's next
``d`` batches on the card from a background thread.

Resilience (``resilience/``, ``training/integrity.py``), armed from the
environment as in the JAX package: a fault plan in
``$TPU_DIST_FAULT_PLAN`` adds a ``FaultInjector`` callback, a process run
under ``run_entry`` a ``PreemptionDrain``, and each execution's batch
passes ``integrity.fire_batch_hook`` before it runs. ``TPU_DIST_INTEGRITY=1``
arms an ``IntegrityGuard``: the steps are built to also return the health
vector (``integrity.StepHealth``; a captured k-step program returns the
window's), the guard judges it one execution behind, and a
``RollbackAndReplay`` restores the newest published checkpoint in place
(``restore_model`` ``copy_``s into the live tensors, so captured programs
and the fused optimizers' leaf tables stay valid), rewinds the data to the
epoch's start and replays. Armed programs are keyed apart from unarmed
ones (``_train_variant``), so an unarmed fit runs, launches and captures
exactly what it did before the guard existed. Under a
``MultiWorkerMirroredStrategy`` the liveness monitor is checked at each
epoch's start. Elasticity: ``$TPU_DIST_REJOIN_DIR`` adds the epoch
``RejoinGate`` and ``$TPU_DIST_GANG_DIR`` the ``StepRejoinGate``, whose
``GangReform`` the loop catches beside ``RollbackAndReplay``
(:meth:`Trainer._gang_reform`: the same in-place restore and rewind, after
the clique is reformed); with neither set, nothing changes.

Under a ``ParameterServerStrategy`` (``parallel/ps_strategy.py``) ``fit``
is the asynchronous worker's loop (:meth:`Trainer._fit_ps`): pull the
published parameters, one forward and backward, push the gradients, until
the server's STOP. Under a job scope (``jobs/runtime.py``) the strategy is
the job's slot and the steps and captured programs are taken from the
job's ``MeshRuntime`` cache (:meth:`Trainer._acquire_program`); outside
one the trainer never imports the runtime.

``fit(profile_dir=D)`` records a ``torch.profiler`` trace of the epochs
into ``D`` on the chief (``utils/profiler.py``), each execution marked
with a step annotation, as the JAX package traces its fit. Captured
programs capture and replay inside the trace as outside it (the card
records the replayed kernels).

``fit(checkpoint_dir=)`` is the JAX package's resume: it restores the
newest complete checkpoint there (or ``TPU_DIST_RESTORE_STEP``: a step, or
``none``) in place (``training/checkpoint.py``), starts at the epoch after
it, and saves every epoch through a ``ModelCheckpoint`` unless one for the
same directory was passed. The random generator is seeded per epoch from
``(seed, epoch)``, as the JAX package folds its keys from the epoch, so a
resumed fit draws the uninterrupted fit's numbers.

``steps_per_execution = k > 1`` runs k train steps per execution, the JAX
package's ``lax.scan`` of k steps in one compiled program: the k batches
arrive stacked on a leading axis and the execution returns their mean
loss. On CUDA in a single process an execution is one captured CUDA graph
of the k steps unrolled (``utils/graphs.py``): the first execution of a
shape runs eagerly (it builds the fused optimizers' leaf tables and moves
training as any execution does), the second captures and replays, and
the stacked batches cross to the card by one pinned copy. One graph of k
unrolled steps is chosen over one graph of a step replayed k times: the
host then pays one launch an execution, as the reference pays one
dispatch, where a replayed step needs k replays and k device copies of
its slice of the batch. The CPU, and a process group (whose all-reduce
a graph would have to capture, which waits for a machine with several
cards: ROADMAP queue 1), run the k steps one after another with the same
kernels. On a ``DeviceDataset`` the gather
runs inside the captured program: the execution's ``[k, B]`` index vector
is its only input, one pinned copy of a few KB, and the gathers and the
scale replay with the steps (an eager gather before the replay would add
a launch per batch and a device copy of the gathered batch into the
program's static input).

Epoch semantics are the JAX package's: one persistent iterator across
epochs when ``steps_per_epoch`` is set, re-created on exhaustion; the epoch
``loss`` is the mean of the steps' losses, each metric the ratio of its
totals over the epoch.

State and modes: the JAX package threads ``variables['state']`` (BatchNorm's
running statistics) through the step and passes ``training=``; here the
state is the model's buffers, updated in place by the step (so a captured
execution updates them too), and the trainer sets ``nn.Module.training``:
train mode in the step, eval mode in ``evaluate`` and ``predict``, the
caller's mode restored after ``fit``, ``evaluate`` and ``predict``. Where
the JAX package folds a key per step for Dropout, the port's Dropout draws
from :attr:`Trainer.rng`, a generator on the model's device seeded by
``fit(seed=)``, which every capture registers so each replay draws anew. A
captured program's identity starts with the compute policy
(``_train_variant``, ``_eval_variant``), so a ``fit`` or ``predict`` after
``set_policy`` captures anew, as the JAX package retraces. A functional
model's state leaves keyed ``aux_loss``, and every mixture-of-experts
layer's, join the training objective under autograd (the JAX package's
``_aux_loss_total``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_dist_torch.data import vectorize
from tpu_dist_torch.data.device import DeviceDataset
from tpu_dist_torch.data.distribute import DistributedDataset
from tpu_dist_torch.data.pipeline import Dataset, DevicePrefetcher
from tpu_dist_torch.models.layers import BatchNormalization, Dropout
from tpu_dist_torch.models.policy import policy
from tpu_dist_torch.parallel import collectives
from tpu_dist_torch.training import integrity
from tpu_dist_torch.training.callbacks import (CallbackList, History,
                                               LazyLogs, StopTraining)
from tpu_dist_torch.utils import graphs, profiler
from tpu_dist_torch.utils.progbar import ProgressBar

logger = logging.getLogger("tpu_dist_torch.trainer")

#: ``fit``/``evaluate`` batch ``(x, y)`` arrays by this many rows, in
#: order, as the JAX package's ``_distribute`` does.
ARRAY_BATCH = 32


def array_batches(x, y, batch_size: int = ARRAY_BATCH) -> Dataset:
    """``(x, y)`` arrays cut into batches of ``batch_size`` rows in order,
    the last one ragged: the batches of ``Dataset.from_tensor_slices((x,
    y)).batch(32)``, sliced instead of stacked row by row."""
    x, y = np.asarray(x), np.asarray(y)
    if len(x) != len(y):
        raise ValueError(f"x and y disagree on the number of rows: {len(x)} "
                         f"vs {len(y)}")

    def factory():
        for i in range(0, len(x), batch_size):
            yield x[i:i + batch_size], y[i:i + batch_size]

    return Dataset(factory, cardinality=-(-len(x) // batch_size))


def _to_device(a, device) -> torch.Tensor:
    """A batch array as a tensor on ``device``: integers as int64 (token
    ids and labels index with it), floats as float32."""
    t = torch.as_tensor(a)
    if t.is_floating_point():
        t = t.to(torch.float32)
    elif t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t.to(device, non_blocking=True)


def _place(x, device, transform):
    """The x batch on ``device``: through :func:`_to_device`, or, with a
    dataset's device transform, in its wire dtype (uint8) and then
    transformed there."""
    if transform is None:
        return _to_device(x, device)
    return transform(torch.as_tensor(x).to(device, non_blocking=True))


def _batch_array(b):
    """A batch as ``predict`` takes it: a tensor as it is (on its device),
    anything else as a numpy array."""
    return b if isinstance(b, torch.Tensor) else np.asarray(b)


def _pad_rows(b, target: int):
    """``b`` (an array or a tensor) padded to ``target`` rows by repeating
    its last row."""
    if isinstance(b, torch.Tensor):
        return torch.cat([b, b[-1:].expand(target - len(b), *b.shape[1:])])
    return np.concatenate([b, np.repeat(b[-1:], target - len(b), axis=0)])


def _dtype_of(a) -> torch.dtype:
    return (a.dtype if isinstance(a, torch.Tensor) else
            torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype)


def _device_dtype(a) -> torch.dtype:
    """The dtype :func:`_to_device` gives a batch (an array or a tensor)."""
    dt = _dtype_of(a)
    if dt.is_floating_point:
        return torch.float32
    return dt if dt == torch.bool else torch.int64


def _transform_key(t):
    """A device transform's identity for the caches of steps and programs:
    two scale transforms of equal op and factor are one program, though
    each DistributedDataset makes its own function."""
    if t is None:
        return None
    op, k = getattr(t, "_op", None), getattr(t, "_scale", None)
    return ("scale", op, k) if k is not None else id(t)


def _epoch_seed(seed: int, epoch: int) -> int:
    """The random generator's seed for ``epoch`` of a ``fit(seed=)``: a
    function of the two alone, as the JAX package folds each step's key
    from its root key and the epoch, so a resumed fit draws what the
    uninterrupted one draws."""
    state = np.random.SeedSequence([seed % 2**64, epoch]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _aux_loss_total(models):
    """The summed ``aux_loss`` state leaves of the last forward of each
    functional model or mixture-of-experts layer in ``models`` (with their
    autograd graph), or None when there are none; each one's record is
    taken."""
    total = None
    for m in models:
        aux, m._aux_loss = m._aux_loss, None
        if aux is not None:
            total = aux if total is None else total + aux
    return total


def _mean_floats(tensors, group=None) -> None:
    """Average the floating-point tensors across the processes of
    ``group``, in place, one collective per dtype."""
    floats = [t for t in tensors if t.is_floating_point()]
    for dtype in dict.fromkeys(t.dtype for t in floats):
        collectives.all_reduce([t for t in floats if t.dtype == dtype],
                               collectives.ReduceOp.MEAN, group=group)


def _current_job():
    """The active job scope (``jobs/runtime.py``), read through
    ``sys.modules``: a run that never imports the jobs runtime pays
    nothing, not even the import, and builds and keeps its programs as
    before (the runtime's solo no-op)."""
    mod = sys.modules.get("tpu_dist_torch.jobs.runtime")
    return mod.current_job() if mod is not None else None


#: Trainer serials: the cache-key part that keeps one model's successive
#: trainers from sharing each other's job-cached programs.
_TRAINER_SERIALS = itertools.count()


def _tensors(tree) -> list:
    """The tensors of a nest of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree for t in _tensors(sub)]


@contextlib.contextmanager
def _mode(model, training: bool):
    """The model in train or eval mode for the block, then in the caller's
    mode again."""
    was = model.training
    model.train(training)
    try:
        yield
    finally:
        model.train(was)


def _run_program(programs: dict, key, held_tensors, make, inputs):
    """Run the captured program of ``key`` on ``inputs``, made by
    ``make()`` first when there is none, or when the tensors it holds
    (``held_tensors``, whose addresses a program bakes in) are no longer
    the ones it was made on."""
    held = [(id(t), t.data_ptr()) for t in _tensors(held_tensors)]
    prog, was = programs.get(key, (None, None))
    if prog is None or was != held:
        prog = make()
        # The program's closure holds the tensors, so their ids stay
        # theirs while it lives.
        programs[key] = (prog, held)
    return prog(**inputs)


class _GraphedExecutions:
    """K-step executions as captured CUDA graphs: one
    :class:`~tpu_dist_torch.utils.graphs.CapturedProgram` per stacked batch
    shape and dtype, whose graphs share one memory pool. With a device
    transform the x batch keeps its wire dtype (uint8) in the program's
    input. A program bakes in the addresses of the tensors it ran on, so a
    call with other variable tensors (another ``loss_acc``, say) or
    another device-resident dataset replaces the shape's program."""

    def __init__(self, multi, device, raw_x: bool, generators=()):
        self.multi, self.device = multi, device
        self._x_dtype = _dtype_of if raw_x else _device_dtype
        self.generators = tuple(generators)
        self.pool = torch.cuda.graph_pool_handle()
        self.programs: dict[tuple, tuple] = {}

    def _run(self, key, held_tensors, fn, specs, inputs):
        make = lambda: graphs.CapturedProgram(
            fn, specs, device=self.device, pool=self.pool,
            generators=self.generators)
        # A replay's loss (and health vector) is the graph's own output,
        # rewritten by the next replay: the caller gets a copy.
        out = _run_program(self.programs, key, held_tensors, make, inputs)
        if isinstance(out, tuple):
            return tuple(t.clone() for t in out)
        return out.clone()

    def __call__(self, params, state, opt_state, metric_states, loss_acc,
                 xs, ys, rng=None):
        variables = (params, state, opt_state, metric_states, loss_acc)
        xspec = (tuple(np.shape(xs)), self._x_dtype(xs))
        yspec = (tuple(np.shape(ys)), _device_dtype(ys))
        return self._run((xspec, yspec), variables,
                         lambda xs, ys: self.multi(*variables, xs, ys),
                         {"xs": xspec, "ys": yspec}, {"xs": xs, "ys": ys})

    def indexed(self, variables, dataset: DeviceDataset, idx: np.ndarray):
        """One execution on a device-resident dataset: the program gathers
        its ``[k, B]`` batches itself from ``idx``, its only input."""
        spec = graphs.spec_of(idx)
        return self._run(
            ("indices", spec, id(dataset)),
            (variables, dataset._dx, dataset._dy),
            lambda idx: self.multi(*variables, *dataset.gather(idx)),
            {"idx": spec}, {"idx": idx})


class Trainer:
    """Owns the training variables of one model and its train step."""

    def __init__(self, model):
        from tpu_dist_torch.parallel.strategy import get_strategy

        self.model = model
        # Under a job scope the strategy is the job's leased slot, and the
        # programs land in the pool's cache (_acquire_program).
        self._job = _current_job()
        self._serial = next(_TRAINER_SERIALS)
        self.strategy = model.strategy or (
            self._job.strategy if self._job is not None else get_strategy())
        #: The replicas' group (the data axis's beside a model or sequence
        #: axis; None: every process).
        self.group = self.strategy.data_group
        #: The forward and backward hold collectives (a model or sequence
        #: axis): no captured programs.
        self.meshed = self.strategy.parallel_mesh is not None
        self.variables: Optional[dict] = None  # params/state/opt/metrics
        self._iterator = None
        self._iterator_source = None
        self._iterator_kind: Optional[str] = None  # "host" or "prefetch"
        self._prefetcher: Optional[DevicePrefetcher] = None
        self._fit_loss_acc: Optional[torch.Tensor] = None
        #: The model's ``gradient_bucket_bytes`` the steps are built with.
        self._bucket_bytes = 0
        # (policy, class_weight, device transform) -> _GraphedExecutions
        self._graphed: dict = {}
        # (policy, device transform, input spec) -> (CapturedProgram, held)
        self._predict_programs: dict = {}
        self._predict_pool = None
        #: The generator Dropout (and a functional model's ``rng``) draw
        #: from, on the model's device; seeded by ``fit(seed=)``.
        self.rng: Optional[torch.Generator] = None
        #: The armed steps' health buffers (``integrity.StepHealth``), made
        #: by the first integrity-armed fit.
        self._step_health: Optional[integrity.StepHealth] = None
        #: An armed fit's start: (epoch, variables), the rollback's target
        #: when no checkpoint is published.
        self._fit_start: Optional[tuple] = None
        #: ``{epoch: DeviceDataset.tell()}`` at each epoch's start.
        self._epoch_marks: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def distributed(self) -> bool:
        """True when the step all-reduces across processes."""
        return self.strategy.num_replicas_in_sync > 1

    def _sync_step_knobs(self) -> None:
        """Adopt the model's ``gradient_bucket_bytes`` (the JAX package's
        ``_sync_step_knobs``): the steps built from here on take its
        schedule, and BatchNorm synchronises its moments across the
        processes only under the default one."""
        self._bucket_bytes = int(self.model.gradient_bucket_bytes or 0)
        for m in self.model.modules():
            if isinstance(m, BatchNormalization):
                m.synchronized = self.distributed and not self._bucket_bytes
                m.sync_group = self.group

    # -- variables -----------------------------------------------------------

    def ensure_variables(self, seed: int = 0) -> None:
        """Build the optimizer state for the model's parameters, and the
        random generator (from ``seed``). Unlike the JAX package, whose
        model holds no parameters until this call initializes them from
        ``seed``, the port's model owns parameters and state from its
        construction (or a weights load); they are used as they are. The
        state is the model's buffers (BatchNorm's running statistics),
        updated in place by the step. In a process group, process 0's
        parameters and state are broadcast, and under the default schedule
        every BatchNorm takes its moments over the global batch
        (``layers._SyncMoments``)."""
        self._sync_step_knobs()
        if self.variables is not None:
            return
        params = list(self.model.parameters())
        state = list(self.model.buffers())
        if self.distributed:
            # Mirrored variables start equal: the first replica's values
            # everywhere (a sharded leaf's on the replicas of its shard).
            collectives.broadcast_from_chief([params, state],
                                             group=self.group)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.model.modules():
            if hasattr(m, "generator"):
                m.generator = self.rng
        optimizer = self.model.optimizer
        self.variables = {
            "params": params,
            "state": state,
            "opt": optimizer.init(params) if optimizer else (),
            "metrics": self._init_metric_states(),
        }
        logger.info("%s: %d parameters on %s", self.model.name,
                    sum(p.numel() for p in params), self.device)

    def _graph_generators(self) -> tuple:
        """The generators a capture must register: the trainer's, when the
        model draws from it (a Dropout, a functional model's ``rng``). A
        registered generator advances its offset on every replay, so each
        replay draws fresh numbers."""
        draws = (getattr(self.model, "_apply_fn", None) is not None
                 or any(isinstance(m, Dropout) for m in self.model.modules()))
        return (self.rng,) if draws else ()

    def _acquire_program(self, kind: str, builder, *variant):
        """``builder()``'s program: outside a job scope made here and kept
        where the caller keeps it, as before; under one, taken from the
        job's ``MeshRuntime`` cache (``runtime.cached``) under a key of the
        job, the model, this trainer and ``kind`` and ``variant``, so the
        pool's program population is inspectable."""
        if self._job is None:
            return builder()
        key = self._job.program_key(self.model.name, self._serial, kind,
                                    *variant)
        return self._job.runtime.cached(key, builder)

    def _init_metric_states(self) -> tuple:
        return tuple(m.init(self.device) for m in self.model.metrics)

    def _init_loss_acc(self) -> torch.Tensor:
        """``[sum of step losses, step count]`` fp32 on the device."""
        return torch.zeros(2, dtype=torch.float32, device=self.device)

    # -- the train step --------------------------------------------------------

    def _loss(self, logits, y, class_weight):
        loss_obj = self.model.loss
        if class_weight is None:
            return loss_obj(logits, y)
        # Keras class_weight semantics: scale each sample's loss by its
        # class's weight (default 1.0) before the batch-size mean.
        if y.is_floating_point():
            raise ValueError(
                "class_weight requires sparse integer labels; got labels of "
                f"dtype {y.dtype}")
        per = loss_obj.per_example(logits, y)
        if per.shape != y.shape:
            raise ValueError(
                "class_weight requires per-example labels matching the loss "
                f"(labels {tuple(y.shape)} vs per-example loss "
                f"{tuple(per.shape)})")
        w = torch.ones_like(per)
        for c, wt in class_weight.items():
            w = torch.where(y == c, torch.full_like(w, wt), w)
        return (per * w).mean()

    def _step(self, class_weight: Optional[dict] = None,
              device_transform=None, health=None):
        """The train step: ``(params, state, opt, metrics, loss_acc, x, y,
        rng=None) -> loss``, or ``(loss, health vector)`` with ``health``
        (an ``integrity.StepHealth``: the parameters are copied before the
        update and the vector reduced after it, on the device). Forward in
        train mode (BatchNorm updates its
        running statistics, the model's buffers, in place), loss, backward
        (the flash backward kernels on CUDA), optimizer update, metric
        update and the device-side loss accumulator, all in place on the
        passed variables; returns the step's loss as a 0-d device tensor
        without reading it. ``params`` and ``state`` must be the model's
        own parameters and buffers (as :meth:`train_state` gives them);
        ``rng`` is accepted for the JAX signature's sake: a Dropout draws
        from :attr:`rng`. ``device_transform`` (a dataset's) runs on x once
        it is on the device."""
        from tpu_dist_torch.models.model import Model, _nest
        from tpu_dist_torch.parallel.expert import MixtureOfExperts

        model, optimizer = self.model, self.model.optimizer
        metrics = tuple(model.metrics)
        device = self.device
        distributed = self.distributed
        group = self.group
        meshed = self.meshed
        bucket_bytes = self._bucket_bytes
        names = [n for n, _ in model.named_parameters()]
        # Functional models and mixture-of-experts layers record their
        # ``aux_loss`` leaves with their autograd graph.
        aux_sources = [m for m in model.modules()
                       if (isinstance(m, Model) and m._apply_fn is not None)
                       or isinstance(m, MixtureOfExperts)]

        def step(params, state, opt_state, metric_states, loss_acc, x, y,
                 rng=None):
            if not model.training:
                model.train()
            x = _place(x, device, device_transform)
            y = _to_device(y, device)
            for p in params:
                p.grad = None
            logits = model(x)
            loss = self._loss(logits, y, class_weight)
            aux = _aux_loss_total(aux_sources)
            if aux is not None:
                loss = loss + aux
            loss.backward()
            grads = [p.grad for p in params]
            loss = loss.detach()
            if distributed and bucket_bytes:
                # The JAX package's bucketed schedule: the mean loss, the
                # gradients in buckets over its flatten order, the mean of
                # the state each shard's BatchNorm moved.
                collectives.all_reduce([loss], collectives.ReduceOp.MEAN,
                                       group=group)
                collectives.bucketed_all_reduce(
                    _nest(zip(names, grads)), collectives.ReduceOp.MEAN,
                    bucket_bytes=bucket_bytes, group=group)
                _mean_floats(state, group)
            elif distributed:
                # One flat all-reduce of the gradients and the loss: the
                # mean over the replicas is the global batch's.
                collectives.all_reduce([*grads, loss],
                                       collectives.ReduceOp.MEAN,
                                       group=group)
            if health is not None:
                health.before(params)
            optimizer.update(grads, opt_state, params)
            with torch.no_grad():
                for m, ms in zip(metrics, metric_states):
                    m.update(ms, logits, y)
                loss_acc[0] += loss
                loss_acc[1] += 1.0
            if health is None:
                return loss
            h = health.after(loss, grads, params)
            if meshed:
                # Shards differ across the mesh's processes: sum their
                # vectors, so every process reaches the same verdict.
                collectives.all_reduce([h], collectives.ReduceOp.SUM)
            return loss, h

        return step

    def _multi_step(self, class_weight: Optional[dict] = None,
                    device_transform=None, health=None):
        """The K-step execution, ``(params, state, opt, metrics, loss_acc,
        xs, ys, rng=None) -> loss``: the train step over ``xs[i], ys[i]``
        for each i of the leading axis in order, returning the mean of the
        K losses (the JAX package's scanned step); with ``health``, also
        the window's health vector (``integrity.reduce_window_health``).
        On CUDA in a single process each execution is a captured graph
        (:class:`_GraphedExecutions`)."""
        step = self._step(class_weight, device_transform, health)

        def multi(params, state, opt_state, metric_states, loss_acc, xs, ys,
                  rng=None):
            outs = [step(params, state, opt_state, metric_states,
                         loss_acc, xs[i], ys[i]) for i in range(len(xs))]
            if health is None:
                return torch.stack(outs).mean()
            losses, healths = zip(*outs)
            return (torch.stack(losses).mean(),
                    integrity.reduce_window_health(torch.stack(healths)))

        if self.device.type != "cuda" or self.distributed or self.meshed:
            return multi
        key = self._train_variant(class_weight, device_transform,
                                  armed=health is not None)
        if key not in self._graphed:
            self._graphed[key] = _GraphedExecutions(
                multi, self.device, raw_x=device_transform is not None,
                generators=self._graph_generators())
        return self._graphed[key]

    @staticmethod
    def _train_variant(class_weight, device_transform, *,
                       armed: bool = False) -> tuple:
        """The identity of a captured training program, the JAX package's
        ``_train_variant``: the policy (a capture made under one compute
        dtype is never replayed under another), the class weights and the
        device transform; an integrity-armed program (which also returns
        the health vector) is another program."""
        key = (policy(),
               None if class_weight is None
               else tuple(sorted(class_weight.items())),
               _transform_key(device_transform))
        return key + ("integrity",) if armed else key

    @staticmethod
    def _eval_variant(device_transform) -> tuple:
        """The identity of a captured eval-mode program (``predict``), the
        JAX package's ``_eval_variant``: the policy and the transform."""
        return policy(), _transform_key(device_transform)

    def make_train_function(self, steps_per_execution: Optional[int] = None):
        """The train step — public surface for benchmarks and custom loops
        (the JAX package's ``make_train_function``)::

            fn(params, state, opt, metrics, loss_acc, x, y, rng=None) -> loss

        Where the JAX step returns ``(loss, params, state, opt, metrics,
        loss_acc, health)`` for the caller to thread into the next call,
        this one updates the variables it is given in place and returns
        the loss alone; call it again with the same :meth:`train_state`.
        With ``steps_per_execution`` (default: the compiled value) k > 1,
        ``x`` and ``y`` carry a leading k axis (k stacked batches) and the
        loss is the k-mean; on CUDA in a single process each call is one
        captured CUDA graph of the k steps (module docstring). Always the
        unweighted loss (``class_weight`` is a fit feature)."""
        k = (steps_per_execution if steps_per_execution is not None
             else self.model.steps_per_execution)
        self.ensure_variables()
        return self._multi_step() if k > 1 else self._step()

    def train_state(self) -> tuple:
        """The live ``(params, state, opt, metrics, loss_acc)`` tuple, in
        the positional order the :meth:`make_train_function` callable
        takes; ``loss_acc`` is fresh."""
        self.ensure_variables()
        v = self.variables
        return (v["params"], v["state"], v["opt"], v["metrics"],
                self._init_loss_acc())

    # -- data --------------------------------------------------------------------

    def _distribute(self, x):
        """The JAX package's ``_distribute`` order: a DeviceDataset bound
        to the trainer's device; a DistributedDataset as it is; a Dataset
        promoted to a DeviceDataset if it can be (the port's scale
        detection accepts chains the JAX package's declines) (one upload for the
        chain, however many fits), else wrapped under its auto-shard
        policy with the device transform allowed (the step applies it);
        ``(x, y)`` arrays as batches of 32 in order."""
        if isinstance(x, DeviceDataset):
            return x.bind_device(self.device)
        if isinstance(x, DistributedDataset):
            return x
        if isinstance(x, Dataset):
            promoted = vectorize.try_promote_to_device(x, self.device)
            if promoted is not None:
                return promoted.bind_device(self.device)
            return DistributedDataset(x, self.strategy,
                                      allow_device_transform=True,
                                      device=self.device)
        if isinstance(x, (tuple, list)) and len(x) == 2:
            return DistributedDataset(array_batches(*x), self.strategy)
        raise TypeError(
            f"fit/evaluate expects a Dataset, DistributedDataset, "
            f"DeviceDataset or (x, y) arrays; got {type(x).__name__}")

    def _next_batch(self, batches: DistributedDataset):
        """Persistent-iterator semantics across epochs (Keras 2): re-create
        on exhaustion. With ``prefetch_to_device > 0`` and one step an
        execution, batches come placed on the device from a
        :class:`DevicePrefetcher`; a k-step execution stacks host batches
        (its copy goes through the program's pinned staging)."""
        depth = self.model.prefetch_to_device
        kind = ("prefetch" if depth > 0 and self.model.steps_per_execution
                == 1 else "host")
        if (self._iterator is None or self._iterator_source is not batches
                or self._iterator_kind != kind):
            self._open_iterator(batches, kind)
        try:
            return next(self._iterator)
        except StopIteration:
            self._open_iterator(batches, kind)
            batch = next(self._iterator, None)
            if batch is None:
                self._close_prefetcher()
                raise RuntimeError("dataset yielded no batches") from None
            return batch

    def _open_iterator(self, batches, kind: str) -> None:
        self._close_prefetcher()
        if kind == "prefetch":
            self._prefetcher = DevicePrefetcher(
                iter(batches), depth=self.model.prefetch_to_device,
                device=self.device)
            self._iterator = self._prefetcher
        else:
            self._iterator = iter(batches)
        self._iterator_source, self._iterator_kind = batches, kind

    def _close_prefetcher(self) -> None:
        """Tear down the device prefetcher (every exit from the epoch
        loop, ``StopTraining`` included): stop its producer, drain the
        batches in flight, join the thread."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
            self._iterator = self._iterator_source = None

    # -- fit / evaluate ------------------------------------------------------

    def fit(self, x, *, epochs: int, steps_per_epoch: Optional[int],
            verbose: int, callbacks: Sequence, initial_epoch: int,
            seed: int, profile_dir: Optional[str] = None,
            validation_data=None, validation_steps: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            class_weight: Optional[dict] = None) -> History:
        self.ensure_variables(seed)
        from tpu_dist_torch.parallel.ps_strategy import \
            ParameterServerStrategy

        if isinstance(self.strategy, ParameterServerStrategy):
            # The asynchronous execution model: pull, local step, push
            # against the PS transport, instead of the epoch loop below.
            if not self.strategy.is_worker:
                raise ValueError(
                    "fit() under ParameterServerStrategy runs on worker "
                    "ranks; the server rank runs PSServer.run() "
                    "(tpu_dist_torch.parallel.ps_strategy)")
            if class_weight:
                raise ValueError(
                    "class_weight is not supported under "
                    "ParameterServerStrategy")
            return self._fit_ps(x, epochs=epochs,
                                steps_per_epoch=steps_per_epoch,
                                verbose=verbose, callbacks=callbacks,
                                initial_epoch=initial_epoch, seed=seed)
        if class_weight is not None:
            class_weight = {int(c): float(w) for c, w in class_weight.items()}
            if any(c < 0 for c in class_weight):
                raise ValueError(f"negative class index in {class_weight}")
            class_weight = class_weight or None  # {} means no weighting
        batches = self._distribute(x)
        transform = getattr(batches, "device_transform", None)
        # $TPU_DIST_INTEGRITY=1 (the chaos CLI's, or an operator's) arms
        # the guard: the steps also return the health vector.
        guard = integrity.maybe_guard_from_env()
        health = None
        if guard is not None:
            if self._step_health is None:
                self._step_health = integrity.StepHealth(
                    self.variables["params"])
            health = self._step_health
        variant = self._train_variant(class_weight, transform,
                                      armed=health is not None)
        step = self._acquire_program(
            "train_step", lambda: self._step(class_weight, transform, health),
            variant)
        multi = (self._acquire_program(
            "multi_step",
            lambda: self._multi_step(class_weight, transform, health),
            variant) if self.model.steps_per_execution > 1 else None)
        if steps_per_epoch is None:
            steps_per_epoch = batches.cardinality()
            if steps_per_epoch is None:
                raise ValueError("the dataset's cardinality is unknown; "
                                 "pass steps_per_epoch")
        callbacks = list(callbacks)
        # A fault plan in $TPU_DIST_FAULT_PLAN (the chaos CLI's, a
        # Supervisor's) rides the fit as one more callback; a process run
        # under run_entry gets the preemption drain after it, so an
        # injected preempt is drained in the same callback round.
        # After them, the elastic gates: $TPU_DIST_REJOIN_DIR holds every
        # epoch's start until the whole gang is there; $TPU_DIST_GANG_DIR
        # (a step-rejoin Supervisor's) arms the mid-epoch reform.
        from tpu_dist_torch.resilience.injector import (
            maybe_injector_from_env, maybe_preemption_drain,
            maybe_rejoin_gate)
        from tpu_dist_torch.resilience.rejoin import (GangReform,
                                                      maybe_step_rejoin_gate)

        gang_gate = maybe_step_rejoin_gate(steps_per_epoch=steps_per_epoch)
        for cb in (maybe_injector_from_env(steps_per_epoch=steps_per_epoch),
                   maybe_preemption_drain(), maybe_rejoin_gate(), gang_gate):
            if cb is not None:
                callbacks.append(cb)
        # $TPU_DIST_OBSERVE_DIR (a Supervisor's, or a shell's) attaches a
        # Telemetry callback, unless the caller passed one.
        from tpu_dist_torch.observe.telemetry import (
            Telemetry, maybe_telemetry_from_env)

        if not any(isinstance(cb, Telemetry) for cb in callbacks):
            telemetry = maybe_telemetry_from_env()
            if telemetry is not None:
                callbacks.append(telemetry)
        if checkpoint_dir is not None:
            initial_epoch = self._resume(checkpoint_dir, initial_epoch)
            callbacks = self._with_checkpoints(checkpoint_dir, callbacks)
        val_batches = val_steps = None
        if validation_data is not None:
            val_batches = self._distribute(validation_data)
            val_steps = validation_steps
        self._epoch_marks = {}
        if guard is not None:
            guard.bind(self.strategy, checkpoint_dir=checkpoint_dir,
                       shard_keys=integrity.shard_keys(self.model))
        if guard is not None or gang_gate is not None:
            # A rollback or a reform with no checkpoint returns here.
            self._fit_start = (initial_epoch, {
                k: t.detach().clone() for k, t in self._live().items()})

        history = History()
        cbs = CallbackList([history, *callbacks], model=self.model)
        cbs.on_train_begin()
        trace = (profiler.trace(profile_dir) if profile_dir is not None
                 else contextlib.nullcontext())
        try:
            with trace, _mode(self.model, True):
                start = initial_epoch
                while True:
                    try:
                        self._run_epochs(step, multi, batches, cbs, start,
                                         epochs, steps_per_epoch,
                                         bool(verbose), val_batches,
                                         val_steps, seed, guard)
                        break
                    except integrity.RollbackAndReplay as rb:
                        # Restore the newest published checkpoint and
                        # replay from its epoch; the guard enforces the
                        # budget (IntegrityAbort escapes fit).
                        start = self._integrity_rollback(
                            rb, guard, cbs, checkpoint_dir, batches)
                    except GangReform as gr:
                        # A peer died mid-epoch: the survivor's side of
                        # the reform, then the loop again from the
                        # consensus epoch (the same per-epoch seeds).
                        start = self._gang_reform(
                            gr, gang_gate, cbs, checkpoint_dir, batches,
                            steps_per_epoch)
        except StopTraining as e:
            logger.info("training stopped early: %s", e)
        finally:
            self._close_prefetcher()
            self._fit_start = None
            cbs.on_train_end()
        return history

    # -- the parameter-server worker -------------------------------------------

    def _build_ps_worker_step(self, device_transform=None):
        """The PS worker's local step, ``(x, y) -> (loss, grads)``: forward
        and backward only (the JAX package's ``ps_worker_step``). No
        update, as the server owns the optimizer state, and no collective,
        as the strategy is one device. On CUDA the LM's step launches the
        flash forward and backward kernels and, with a fused loss, the
        fused CE pair."""
        from tpu_dist_torch.models.model import Model
        from tpu_dist_torch.parallel.expert import MixtureOfExperts

        model, device = self.model, self.device
        params = self.variables["params"]
        aux_sources = [m for m in model.modules()
                       if (isinstance(m, Model) and m._apply_fn is not None)
                       or isinstance(m, MixtureOfExperts)]

        def step(x, y):
            x = _place(x, device, device_transform)
            y = _to_device(y, device)
            for p in params:
                p.grad = None
            logits = model(x)
            loss = model.loss(logits, y)
            aux = _aux_loss_total(aux_sources)
            if aux is not None:
                loss = loss + aux
            loss.backward()
            return loss.detach(), [p.grad for p in params]

        return step

    def _fit_ps(self, x, *, epochs: int, steps_per_epoch: Optional[int],
                verbose: int, callbacks: Sequence, initial_epoch: int,
                seed: int) -> History:
        """The worker side of asynchronous PS training: pull the
        parameters (bounded staleness is enforced there), run one local
        step, push the gradients, until the server orders STOP or the
        local cap is reached. "Epochs" are local-step bookkeeping, so
        History and callbacks keep their shape. Dropout draws from the
        trainer's generator reseeded per (rank, local step)
        (``worker_step_key``). Checkpoints and validation stay with the
        server."""
        from tpu_dist_torch.observe.telemetry import (
            Telemetry, maybe_telemetry_from_env)
        from tpu_dist_torch.parallel import ps_strategy
        from tpu_dist_torch.resilience.injector import (
            maybe_injector_from_env, maybe_preemption_drain)

        strategy = self.strategy
        batches = self._distribute(x)
        transform = getattr(batches, "device_transform", None)
        if steps_per_epoch is None:
            steps_per_epoch = batches.cardinality()
            if steps_per_epoch is None:
                raise ValueError("the dataset's cardinality is unknown; "
                                 "pass steps_per_epoch")
        ps_step = self._acquire_program(
            "ps_worker_step", lambda: self._build_ps_worker_step(transform),
            _transform_key(transform))
        callbacks = list(callbacks)
        for cb in (maybe_injector_from_env(steps_per_epoch=steps_per_epoch),
                   maybe_preemption_drain()):
            if cb is not None:
                callbacks.append(cb)
        if not any(isinstance(cb, Telemetry) for cb in callbacks):
            telemetry = maybe_telemetry_from_env()
            if telemetry is not None:
                callbacks.append(telemetry)
        history = History()
        cbs = CallbackList([history, *callbacks], model=self.model)
        show = bool(verbose)
        root_key = seed ^ 0x5EED
        template = ps_strategy.params_tree(self.model)
        names = [n for n, _ in self.model.named_parameters()]
        rank = strategy.rank
        world = max(1, strategy.num_workers)
        # The cap is the global budget, not this worker's share: under a
        # straggler the fast workers cover its applies, and the server's
        # STOP is the real end.
        max_local = (epochs - initial_epoch) * steps_per_epoch * world
        local_step = 0
        stopped = False
        logger.info("PS worker %d: staleness=%d, steps_per_epoch=%d, "
                    "local cap=%d", rank, strategy.staleness,
                    steps_per_epoch, max_local)
        cbs.on_train_begin()
        try:
            with _mode(self.model, True):
                for epoch in range(initial_epoch, epochs * world):
                    cbs.on_epoch_begin(epoch)
                    if show:
                        print(f"Epoch {epoch + 1}/{epochs} (PS worker "
                              f"{rank})")
                    bar = ProgressBar(steps_per_epoch, enabled=show)
                    loss_sum = 0.0
                    steps_this_epoch = 0
                    t_epoch = time.perf_counter()
                    for si in range(steps_per_epoch):
                        pulled = strategy.pull(template)
                        if pulled is None:  # the server ordered STOP
                            stopped = True
                            break
                        ps_strategy.load_params(self.model, pulled[0])
                        xb, yb = (batches.next_batch()
                                  if isinstance(batches, DeviceDataset)
                                  else self._next_batch(batches))
                        ps_strategy.worker_step_key(
                            root_key, rank=rank, local_step=local_step,
                            generator=self.rng)
                        loss, grads = ps_step(xb, yb)
                        # The straggler seam, between compute and push:
                        # the sync stack's collective fault hook, so one
                        # fault grammar serves both execution models.
                        collectives.fire_fault_hook("ps_step")
                        loss_val = float(loss)
                        strategy.push(ps_strategy.named_tree(
                            zip(names, grads)), loss=loss_val)
                        strategy.heartbeat(step=local_step)
                        local_step += 1
                        steps_this_epoch += 1
                        loss_sum += loss_val
                        bar.update(si + 1, loss=loss_sum / steps_this_epoch)
                        cbs.on_batch_end(si, {"loss": loss_val})
                        if local_step >= max_local:
                            stopped = True
                            break
                    if steps_this_epoch:
                        logs = {"loss": loss_sum / steps_this_epoch,
                                "epoch_time": time.perf_counter() - t_epoch}
                        bar.finish(logs)
                        cbs.on_epoch_end(epoch, logs)
                    if stopped:
                        break
        except StopTraining as e:
            logger.info("PS worker %d stopped early: %s", rank, e)
        finally:
            self._close_prefetcher()
            strategy.mark_done(steps=local_step)
            cbs.on_train_end()
        logger.info("PS worker %d done: %d local steps, %d pushes",
                    rank, local_step, strategy.pushed)
        return history

    def _live(self) -> dict:
        """The live training variables (parameters, buffers, optimizer
        state), keyed as a checkpoint keys them."""
        from tpu_dist_torch.models import bridge

        return bridge.checkpoint_tensors(self.model, self.variables["opt"])

    def _integrity_rollback(self, rb, guard, cbs, checkpoint_dir,
                            batches) -> int:
        """Rollback-and-replay: commit any save in flight, restore the
        newest published step (strictly older than the last restore when
        the replay hit the same anomaly again) in place, or the variables
        the fit started with when none is published; rewind the data to
        that epoch's start. Returns the epoch to replay from."""
        from tpu_dist_torch.observe import metrics as metrics_lib
        from tpu_dist_torch.resilience import events
        from tpu_dist_torch.training import checkpoint
        from tpu_dist_torch.training.callbacks import ModelCheckpoint

        for cb in cbs.callbacks:
            if isinstance(cb, ModelCheckpoint) and cb._ckpt is not None:
                try:
                    cb._ckpt.wait()
                except OSError as exc:  # that step is lost, not the run
                    logger.warning("checkpoint write failed before a "
                                   "rollback: %s", exc)
        restored = None
        if checkpoint_dir is not None:
            step = checkpoint.latest_complete_step(
                checkpoint_dir, before=guard.rollback_plan(rb))
            # The chief's directory decides, on every process.
            step = checkpoint._chief_choice(-1 if step is None else step)
            if step >= 0:
                restored = step
        next_epoch = self._restore_to(restored, checkpoint_dir, batches)
        guard.note_rollback(rb, restored)
        metrics_lib.inc("integrity.rollbacks")
        events.maybe_log("integrity_rollback", kind=rb.kind, step=rb.gstep,
                         restored_step=restored, next_epoch=next_epoch,
                         attempt=events.current_attempt())
        logger.warning(
            "integrity rollback: anomaly %r at global step %d; restored "
            "checkpoint step %s, replaying from epoch %d",
            rb.kind, rb.gstep, restored, next_epoch)
        return next_epoch

    def _restore_to(self, step: Optional[int], checkpoint_dir,
                    batches) -> int:
        """Restore checkpoint ``step`` in place, or the variables the fit
        started with when ``step`` is None; rewind the data to the start
        of the epoch after it. Returns that epoch."""
        from tpu_dist_torch.training import checkpoint

        if step is None:
            next_epoch, values = self._fit_start
            with torch.no_grad():
                for key, t in self._live().items():
                    t.copy_(values[key])
        else:
            next_epoch = checkpoint.restore_model(
                checkpoint_dir, self.model, step=step, trainer=self) + 1
        # Replay re-reads the epoch's batches from its start: a host
        # pipeline's iterator anew (what a restarted attempt would read), a
        # device-resident dataset's cursor where that epoch found it.
        self._close_prefetcher()
        self._iterator = self._iterator_source = None
        if isinstance(batches, DeviceDataset):
            batches.seek(self._epoch_marks.get(next_epoch))
        return next_epoch

    def _gang_reform(self, gr, gate, cbs, checkpoint_dir, batches,
                     steps_per_epoch: int) -> int:
        """The survivor's side of a mid-epoch gang reform, in the JAX
        package's order: quiesce the prefetcher; publish every
        ``ModelCheckpoint``'s save in flight and ack with the newest
        complete step (the Supervisor relaunches the lost rank only after
        every ack, so the replacement sees the published state); reform
        the clique under the new generation (``bootstrap.reinitialize``:
        a new process group when one is up, whose mesh subgroups are
        rebuilt; the trainer's data group and BatchNorm groups are read
        anew); wait for the consensus restore step and restore it in place
        (None: the fit's starting variables); meet the relaunched rank at
        the gate's rendezvous. Records ``elastic.gang_reforms``,
        ``drain_s``, ``reform_s``, ``restore_s`` and a ``gang_reform``
        event. Returns the epoch to replay from."""
        from tpu_dist_torch.cluster import bootstrap
        from tpu_dist_torch.observe import metrics as metrics_lib
        from tpu_dist_torch.resilience import events
        from tpu_dist_torch.training import checkpoint
        from tpu_dist_torch.training.callbacks import ModelCheckpoint

        self._close_prefetcher()
        self._iterator = self._iterator_source = None
        for cb in cbs.callbacks:
            if isinstance(cb, ModelCheckpoint):
                cb.publish_in_flight()
        available = (checkpoint.latest_complete_step(checkpoint_dir)
                     if checkpoint_dir is not None else None)
        drain_s = time.monotonic() - gr.seen_at
        bootstrap.ack_reform(gate.directory, generation=gr.generation,
                             rank=gate.rank, available_step=available)

        t_reform = time.monotonic()
        bootstrap.reinitialize(generation=gr.generation)
        gate.generation = gr.generation
        if bootstrap.is_initialized():
            self.group = self.strategy.data_group
            self._sync_step_knobs()

        t_restore = time.monotonic()
        deadline = t_restore + gate.timeout_s
        while True:
            published, step = bootstrap.read_restore_step(
                gate.directory, generation=gr.generation)
            if published:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"gang reform: no consensus restore step for generation "
                    f"{gr.generation} within {gate.timeout_s:.1f}s")
            time.sleep(0.05)
        if checkpoint_dir is None:
            step = None
        next_epoch = self._restore_to(step, checkpoint_dir, batches)
        restore_s = time.monotonic() - t_restore

        gate.rendezvous(step=next_epoch * steps_per_epoch, epoch=next_epoch)
        reform_s = time.monotonic() - t_reform

        metrics_lib.inc("elastic.gang_reforms")
        metrics_lib.observe_value("elastic.drain_s", drain_s)
        metrics_lib.observe_value("elastic.reform_s", reform_s)
        metrics_lib.observe_value("elastic.restore_s", restore_s)
        events.maybe_log(
            "gang_reform", generation=gr.generation,
            lost_ranks=gr.lost_ranks, rank=gate.rank,
            detect_s=gr.request.get("detect_s"),
            drain_s=round(drain_s, 6), reform_s=round(reform_s, 6),
            restore_s=round(restore_s, 6), restored_step=step,
            next_epoch=next_epoch, attempt=events.current_attempt())
        logger.warning(
            "gang reform: lost rank(s) %s; reformed at generation %d, "
            "restored checkpoint step %s, replaying from epoch %d "
            "(drain %.3fs reform %.3fs restore %.3fs)", gr.lost_ranks,
            gr.generation, step, next_epoch, drain_s, reform_s, restore_s)
        return next_epoch

    def _resume(self, checkpoint_dir, initial_epoch: int) -> int:
        """Restore the newest complete checkpoint of ``checkpoint_dir`` in
        place, or the step ``TPU_DIST_RESTORE_STEP`` names (``none``:
        none); a restored step N means epoch N finished. Returns the epoch
        to start at."""
        from tpu_dist_torch.training import checkpoint

        forced = os.environ.get("TPU_DIST_RESTORE_STEP")
        try:
            if forced == "none":
                return initial_epoch
            restored = checkpoint.restore_model(
                checkpoint_dir, self.model, trainer=self,
                step=int(forced) if forced else None)
        except FileNotFoundError:
            return initial_epoch
        start = max(initial_epoch, restored + 1)
        logger.info("resumed from checkpoint step %d; starting at epoch %d",
                    restored, start)
        from tpu_dist_torch.resilience import events

        events.maybe_log("checkpoint_resume", step=restored,
                         initial_epoch=start)
        return start

    @staticmethod
    def _with_checkpoints(checkpoint_dir, callbacks: list) -> list:
        """``callbacks`` and a ``ModelCheckpoint`` of ``checkpoint_dir``,
        unless one for that directory is among them already."""
        from tpu_dist_torch.training.callbacks import ModelCheckpoint

        def same_dir(cb):
            d = getattr(cb, "directory", None)
            return d is not None and os.fspath(d) == os.fspath(checkpoint_dir)

        if any(isinstance(cb, ModelCheckpoint) and same_dir(cb)
               for cb in callbacks):
            return callbacks
        return [*callbacks, ModelCheckpoint(checkpoint_dir)]

    def _reset_accumulators(self) -> torch.Tensor:
        """Zero the epoch's accumulators in place and return the loss
        accumulator: the metric states and one loss accumulator stay the
        same tensors across epochs and fits, so the captured executions
        that add to them stay valid."""
        for metric, state in zip(self.model.metrics,
                                 self.variables["metrics"]):
            for name, fresh in metric.init(self.device).items():
                state[name].copy_(fresh)
        if self._fit_loss_acc is None:
            self._fit_loss_acc = self._init_loss_acc()
        return self._fit_loss_acc.zero_()

    def _execute(self, step, multi, batches, k: int, gstep0: int,
                 clock=None):
        """One execution of ``k`` steps over the next ``k`` batches;
        returns its output (the loss, the k-mean; with the guard armed,
        ``(loss, health)``) and the time ``clock()`` read once the batches
        were fetched (0.0 without a clock: the step timer's data-wait ends
        there). Every batch passes ``integrity.fire_batch_hook`` first
        (``gstep0``: the window's first global step). A window whose
        batches do not all have one shape (a ``drop_remainder=False``
        tail) runs step by step and returns the last step's output, as the
        JAX package does. A DeviceDataset gathers the batches on the
        device: one at k = 1, k stacked for an execution, whose captured
        program gathers them itself from the index vector (module
        docstring) unless a batch hook must see the batches."""
        fetched = clock or float
        fire = integrity.fire_batch_hook
        v = self.variables
        variables = (v["params"], v["state"], v["opt"], v["metrics"],
                     self._fit_loss_acc)
        if isinstance(batches, DeviceDataset):
            if k == 1:
                xb, yb = fire(gstep0, 1, *batches.next_batch())
                t = fetched()
                return step(*variables, xb, yb), t
            if (isinstance(multi, _GraphedExecutions)
                    and not integrity.batch_hook_installed()):
                idx = batches.next_indices(k)
                t = fetched()
                return multi.indexed(variables, batches, idx), t
            xs, ys = fire(gstep0, k, *batches.next_stack(k))
            t = fetched()
            return multi(*variables, xs, ys), t
        if k == 1:
            xb, yb = fire(gstep0, 1, *self._next_batch(batches))
            t = fetched()
            return step(*variables, xb, yb), t
        window = [self._next_batch(batches) for _ in range(k)]
        t = fetched()
        if len({(np.shape(x), np.shape(y)) for x, y in window}) > 1:
            for j, (xb, yb) in enumerate(window):
                out = step(*variables, *fire(gstep0 + j, 1, xb, yb))
            return out, t
        xs, ys = fire(gstep0, k, np.stack([x for x, _ in window]),
                      np.stack([y for _, y in window]))
        return multi(*variables, xs, ys), t

    def _skip(self, batches, k: int) -> None:
        """Draw an execution's batches without training on them (a
        quarantined window): the data stays aligned."""
        if isinstance(batches, DeviceDataset):
            batches.next_indices(k)
        else:
            for _ in range(k):
                self._next_batch(batches)

    def _run_epochs(self, step, multi, batches, cbs, initial_epoch, epochs,
                    steps_per_epoch, show, val_batches, val_steps, seed,
                    guard=None):
        from tpu_dist_torch.observe.telemetry import active_step_timer
        from tpu_dist_torch.resilience import events

        v = self.variables
        k = self.model.steps_per_execution
        monitor = getattr(self.strategy, "liveness_monitor", None)
        # A Telemetry callback's on_train_begin has installed it; without
        # one the loop pays one is-None check per execution.
        timer = active_step_timer()
        clock = time.perf_counter if timer is not None else None
        # The timer's device time: a blocking wait for the execution's
        # end on the stream it ran on (on the CPU it has ended already).
        stream = (torch.cuda.current_stream(self.device)
                  if timer is not None and self.device.type == "cuda"
                  else None)
        leaves = (integrity.named_leaves(self.model) if guard is not None
                  else None)
        for epoch in range(initial_epoch, epochs):
            if monitor is not None:
                # A dead peer surfaces as a restartable error here instead
                # of hanging the next collective.
                monitor.raise_if_failed()
            if isinstance(batches, DeviceDataset):
                # Where a rollback to this epoch rewinds the data to.
                self._epoch_marks[epoch] = batches.tell()
            # A replay of a captured program reads the registered
            # generator's seed and offset as they stand.
            self.rng.manual_seed(_epoch_seed(seed, epoch))
            cbs.on_epoch_begin(epoch)
            if show:
                print(f"Epoch {epoch + 1}/{epochs}")
            bar = ProgressBar(steps_per_epoch, enabled=show)
            loss_acc = self._reset_accumulators()  # per epoch
            # The per-execution host read of the loss is paid only when
            # something consumes it; otherwise the host runs ahead of the
            # device.
            eager_loss = show or cbs.has_batch_hooks
            loss_running = 0.0
            t_epoch = time.perf_counter()
            step_i = executions = 0
            while step_i < steps_per_epoch:
                kk = min(k, steps_per_epoch - step_i)
                gstep0 = epoch * steps_per_epoch + step_i
                if guard is not None and guard.should_skip(gstep0, kk):
                    # Quarantined window (opt-in): replaying data that
                    # poisoned the run would poison it again.
                    self._skip(batches, kk)
                    events.maybe_log("integrity_quarantine_skip",
                                     step=gstep0, window=kk)
                    step_i += kk
                    executions += 1
                    continue
                # Step-phase timing: data-wait ends once the batches are
                # fetched, dispatch when the step (or the replay) returns,
                # device time is the blocking wait on the card.
                t_exec0 = time.perf_counter() if timer is not None else 0.0
                with profiler.step_annotation(gstep0):
                    out, t_fetch = self._execute(step, multi, batches, kk,
                                                 gstep0, clock)
                step_i += kk
                executions += 1
                if guard is not None:
                    # One-behind judgement: this vector's host copy starts
                    # now, the previous one's is judged; the audit when due.
                    loss, health = out
                    guard.on_execution(gstep0, kk, health, leaves)
                else:
                    loss = out
                if timer is not None:
                    t_disp = time.perf_counter()
                    if stream is not None:
                        stream.synchronize()
                    timer.record_execution(
                        steps=kk, data_wait_s=t_fetch - t_exec0,
                        dispatch_s=t_disp - t_fetch,
                        device_block_s=time.perf_counter() - t_disp)
                if eager_loss:
                    # Batch hooks fire once per execution, with its loss;
                    # the bar advances by its steps.
                    loss_val = float(loss)
                    loss_running += loss_val
                    bar.update(step_i, loss=loss_running / executions)
                    cbs.on_batch_end(step_i - 1, {"loss": loss_val})
            if guard is not None:
                # The last execution's vector, before the epoch's callbacks:
                # a poisoned final step never reaches ModelCheckpoint.
                guard.flush()
            # No host read at the epoch's end: the results are copied to
            # the host without blocking and read when someone reads them
            # (LazyLogs) — the bar when verbose, a callback, History.
            device_logs = self._results(loss_acc, v["metrics"])
            logs = LazyLogs({"epoch_time": time.perf_counter() - t_epoch},
                            device_logs)
            if val_batches is not None:
                logs.absorb(self._evaluate_on(val_batches, val_steps),
                            prefix="val_")
            bar.finish(logs)
            cbs.on_epoch_end(epoch, logs)

    def _results(self, loss_acc, metric_states) -> dict:
        """The epoch's (or pass's) loss mean and each metric's result as 0-d
        device tensors, for :class:`LazyLogs` to copy to the host without
        blocking. Across processes, the loss accumulator is averaged (its
        step losses are per-process means) and the metric totals summed
        first."""
        if self.distributed:
            collectives.all_reduce([loss_acc], collectives.ReduceOp.MEAN,
                                   group=self.group)
            states = [t for ms in metric_states for t in ms.values()]
            collectives.all_reduce(states, collectives.ReduceOp.SUM,
                                   group=self.group)
        device_logs = {"loss": loss_acc[0] / torch.clamp(loss_acc[1],
                                                         min=1.0)}
        for metric, mstate in zip(self.model.metrics, metric_states):
            device_logs[metric.name] = metric.result(mstate)
        return device_logs

    def evaluate(self, x, *, steps: Optional[int], verbose: int) -> dict:
        self.ensure_variables()
        logs = self._evaluate_on(self._distribute(x), steps).copy()
        if verbose:
            print(" - ".join(f"{k}: {v_:.4f}" for k, v_ in logs.items()))
        return logs

    def _evaluate_on(self, batches, steps: Optional[int]) -> dict:
        """One evaluation pass in eval mode (all batches, or the first
        ``steps``; a DeviceDataset's from its own seed stream, which leaves
        the training order as it was): the mean of the batches' losses and
        each metric's ratio. Eager on every device."""
        model, loss_obj = self.model, self.model.loss
        transform = getattr(batches, "device_transform", None)
        metric_states = self._init_metric_states()
        loss_acc = self._init_loss_acc()
        count = 0
        with torch.no_grad(), _mode(model, False):
            for xb, yb in itertools.islice(iter(batches), steps):
                xb = _place(xb, self.device, transform)
                yb = _to_device(yb, self.device)
                logits = model(xb)
                for m, ms in zip(model.metrics, metric_states):
                    m.update(ms, logits, yb)
                loss_acc[0] += loss_obj(logits, yb)
                loss_acc[1] += 1.0
                count += 1
        if count == 0:
            raise RuntimeError("evaluate: dataset yielded no batches")
        return LazyLogs(device_logs=self._results(loss_acc, metric_states))

    # -- predict ---------------------------------------------------------------

    def predict(self, x) -> np.ndarray:
        """Eval-mode outputs, as numpy, for an array or a tensor (one
        batch, as the JAX package takes it) or an iterable of batches or of
        ``(x, y)`` tuples (a ``DeviceDataset``'s batches stay on its device:
        nothing is copied to the host but the outputs, once). A dataset's
        device transform (``device_transform``, else a plain ``Dataset``'s
        ``_device_transform``, as the JAX package reads it) runs on each
        batch on the device. Every batch is padded (by repeating its last
        row) to the largest batch's size and its outputs trimmed, so the
        pass needs one program: on CUDA one capture per policy, device
        transform and input, whose first call runs eagerly and whose later
        ones replay; on the CPU the forward itself."""
        self.ensure_variables()
        is_array = (isinstance(x, (np.ndarray, torch.Tensor))
                    or hasattr(x, "__array__"))
        transform = None if is_array else getattr(
            x, "device_transform", getattr(x, "_device_transform", None))
        if is_array:
            batches = [x if isinstance(x, torch.Tensor) else np.asarray(x)]
        else:
            batches = [_batch_array(b[0] if isinstance(b, tuple) else b)
                       for b in x]
        sizes = [len(b) for b in batches]
        if not sizes:
            return np.concatenate([], axis=0)
        target = max(sizes)
        outs = []
        with torch.no_grad(), _mode(self.model, False):
            for xb, n in zip(batches, sizes):
                if n < target:
                    xb = _pad_rows(xb, target)
                # A replay's output is rewritten by the next replay: keep
                # a device copy of the rows wanted.
                outs.append(self._predict_batch(xb, transform)[:n].clone())
        return torch.cat(outs).cpu().numpy()

    def _predict_batch(self, xb, transform) -> torch.Tensor:
        """The eval forward of one batch (an array or a tensor), as a tensor
        on the model's device."""
        model, device = self.model, self.device
        if device.type != "cuda" or self.meshed:
            return model(_place(xb, device, transform))
        # The static input takes the dtype _place gives the batch (the
        # wire dtype under a transform); the staging copy casts into it.
        spec = (tuple(xb.shape),
                _dtype_of(xb) if transform is not None else _device_dtype(xb))
        if self._predict_pool is None:
            self._predict_pool = torch.cuda.graph_pool_handle()
        fn = ((lambda xb: model(transform(xb))) if transform is not None
              else (lambda xb: model(xb)))
        key = (*self._eval_variant(transform), spec)
        held = (list(model.parameters()), list(model.buffers()))
        make = lambda: self._acquire_program(
            "predict", lambda: graphs.CapturedProgram(
                fn, {"xb": spec}, device=device, pool=self._predict_pool),
            key, tuple((id(t), t.data_ptr()) for t in _tensors(held)))
        return _run_program(self._predict_programs, key, held, make,
                            {"xb": xb})
