"""Checkpoint / resume: the chief writes, everyone restores.

Counterpart of the v1 half of ``tpu_dist/training/checkpoint.py``, in its
on-disk layout byte for byte, so a directory written by either package
loads in the other:

    <directory>/checkpoint            the latest step, as text
    <directory>/ckpt-<step>/arrays.npz
    <directory>/ckpt-<step>/manifest.json
        {"step", "keys", "format": "tpu_dist.checkpoint.v1",
         "process_count", "device_count"}

``arrays.npz`` keys every array by the reference's ``keystr`` path in
``{'params', 'state', 'opt'}`` (``models/bridge.py`` translates the port's
parameter names, buffers and optimizer lists to those paths). A step is
staged in a temporary directory, every file and the stage fsynced, then
published with ``os.replace`` and the parent fsynced, then the pointer is
replaced the same way: a crash leaves either the old step or the new one.

Where the reference restores a host pytree and places it anew, the port
restores in place: every parameter, buffer and optimizer tensor is
``copy_``-ed on its own device and never replaced, so the trainer's
captured programs (``Trainer._graphed``) and the fused optimizers' leaf
tables (``ops/fused.py``), which hold those tensors, stay valid.

Several processes: only the chief writes, and everyone meets at a barrier
after the write (``cluster/bootstrap.py``); on restore the chief reads and
``parallel/collectives.broadcast_from_chief`` sends its bytes to the
others. Under a model axis (``parallel/tensor.py``) a checkpoint still
holds the global arrays, in the same layout: each sharded leaf (a
parameter and its optimizer states) is gathered over the axis before the
write, and a restore copies into each process its block of the global
array by the restoring model's own layout, so a checkpoint restores onto
any other mesh (the reference's cross-topology restore). :class:`AsyncCheckpointer` moves serialization and the publish to
a background thread.

A fault seam (:func:`install_write_fault_hook`) sees every staged step
on the chief right before it is published, in :func:`save` and on the
async writer's thread alike: a hook that raises ``OSError`` costs that
step (nothing is published), one that corrupts the stage leaves a step
that validation rejects, and one that exits the process leaves the stage
unpublished (``kill_during_save``).

``sharded=True`` writes the reference's v2 layout instead:

    <directory>/ckpt-<step>/arrays-shard-<p>.npz   process p's blocks
    <directory>/ckpt-<step>/shards-<p>.json        {key: [{name, slices}]}
    <directory>/ckpt-<step>/arrays.npz             the replicated leaves
    <directory>/ckpt-<step>/manifest.json
        {"step", "format": "tpu_dist.checkpoint.v2-sharded",
         "process_count", "device_count", "leaves": {key: {shape, dtype,
         sharded}}}

Each process writes only its own block of every leaf placed across
processes (:func:`_shard_layout`: a model, pipe or expert axis), as the
slices of the global array; of the processes that hold the same block (its
data-axis replicas) the one at coordinate 0 of every other axis writes it.
The chief writes the replicated leaves and the manifest. There is no
gather: three barriers (``checkpoint_stage_``, ``checkpoint_written_``,
``checkpoint_save_``) bracket a stage directory the chief makes and
publishes, so every process needs the directory on a shared filesystem.
Asynchronously each process writes its part on its writer thread and the
commit (:meth:`AsyncCheckpointer._commit_sharded`) sums a failure flag
over the processes before the chief publishes. A restore stitches each
leaf's global array from the indices (:func:`_iter_sharded_leaves`) on
every process and copies each process's block under the restoring model's
own layout, so a v2 step restores onto any process count
(reshape-on-restore, which :func:`_note_reshape` records); a leaf stored
sharded whose dimension the restoring mesh's axis does not divide raises
(:func:`_check_divisible_placement`).
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import shutil
import tempfile
import threading
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.models import bridge
from tpu_dist_torch.observe import metrics as metrics_lib

logger = logging.getLogger("tpu_dist_torch.checkpoint")

_POINTER = "checkpoint"
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_FORMAT_V1 = "tpu_dist.checkpoint.v1"
_FORMAT_V2 = "tpu_dist.checkpoint.v2-sharded"


def _shard_arrays(process: int) -> str:
    return f"arrays-shard-{process}.npz"


def _shard_index(process: int) -> str:
    return f"shards-{process}.json"


def _step_dir(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"ckpt-{step}"


def _saveable(model_or_variables) -> dict:
    """``{key: tensor or array}`` of what a checkpoint holds. A model gives
    its live tensors (through its trainer, made if it has none, whose
    optimizer state comes along); a variables dict (``{'params': …,
    'state': …, 'opt': …}`` trees) is keyed as it stands."""
    from tpu_dist_torch.models.model import Model

    if isinstance(model_or_variables, Model):
        return _live_tensors(model_or_variables)
    if not isinstance(model_or_variables, dict):
        raise TypeError(f"save takes a Model or a variables dict, not "
                        f"{type(model_or_variables).__name__}")
    return bridge.flatten_keys({k: model_or_variables[k]
                                for k in ("params", "state", "opt")
                                if k in model_or_variables})


def _live_tensors(model, trainer=None, *, gathered: bool = True) -> dict:
    """The model's live checkpoint tensors, keyed; under a model axis the
    sharded ones gathered to global tensors (a collective), unless not
    ``gathered``."""
    from tpu_dist_torch.training.trainer import Trainer

    if trainer is None:
        if model._trainer is None:
            model._trainer = Trainer(model)
        trainer = model._trainer
    trainer.ensure_variables()
    live = bridge.checkpoint_tensors(model, trainer.variables["opt"])
    layout = _shard_layout(model, trainer)
    if not gathered or not layout:
        return live
    from tpu_dist_torch.parallel.tensor import gather_leaf

    owners = model._tensor_parallel[2]
    names = bridge.checkpoint_names(model, trainer.variables["opt"])
    return {k: gather_leaf(t, layout[k][0], owners[names[k]])
            if k in layout else t for k, t in live.items()}


def _shard_layout(model, trainer) -> dict:
    """``{checkpoint key: (dim, axis size, coordinate)}`` of the keys whose
    tensors are blocks under a model, pipe or expert axis (a parameter's
    and its optimizer states'); empty without one."""
    tp = model._tensor_parallel
    if tp is None:
        return {}
    names = bridge.checkpoint_names(model, trainer.variables["opt"])
    return {k: tp[1][n] for k, n in names.items() if n in tp[1]}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# -- durability: stage, fsync, rename, fsync the parent -------------------------

def _fsync(path: pathlib.Path) -> None:
    """fsync a file or a directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish_stage(stage: pathlib.Path, target: pathlib.Path,
                   directory: pathlib.Path, step: int) -> None:
    """Durably publish a staged step (chief only): fsync every staged file
    and the stage, rename it into place, fsync the parent, then replace the
    ``checkpoint`` pointer the same way."""
    for child in sorted(stage.iterdir()):
        if child.is_file():
            _fsync(child)
    _fsync(stage)
    if target.exists():
        shutil.rmtree(target)
    os.replace(stage, target)
    _fsync(directory)
    pointer_tmp = directory / (_POINTER + ".tmp")
    pointer_tmp.write_text(str(step))
    _fsync(pointer_tmp)
    os.replace(pointer_tmp, directory / _POINTER)
    _fsync(directory)


#: The write fault hook, ``hook(stage_dir, step)`` (None in production: one
#: pointer check a save).
_WRITE_FAULT_HOOK = None


def install_write_fault_hook(hook):
    """Install (or, with None, remove) the checkpoint write fault hook;
    returns the previous one. The hook runs on the chief with the fully
    staged step directory right before :func:`_publish_stage` (on the
    writer thread for an async save)."""
    global _WRITE_FAULT_HOOK
    prev = _WRITE_FAULT_HOOK
    _WRITE_FAULT_HOOK = hook
    return prev


def _fire_write_fault(stage: pathlib.Path, step: int) -> None:
    if _WRITE_FAULT_HOOK is not None:
        _WRITE_FAULT_HOOK(stage, step)


def _write_v1_checkpoint(directory: pathlib.Path, flat: dict, *, step: int,
                         max_to_keep: Optional[int]) -> str:
    """Serialize and durably publish one v1 step from host arrays (chief
    only; no collective, no barrier), shared by :func:`save` and the
    :class:`AsyncCheckpointer`'s writer thread."""
    directory.mkdir(parents=True, exist_ok=True)
    target = _step_dir(directory, step)
    with tempfile.TemporaryDirectory(dir=directory) as tmp:
        stage = pathlib.Path(tmp) / "stage"
        stage.mkdir()
        np.savez(stage / _ARRAYS, **flat)
        (stage / _MANIFEST).write_text(json.dumps({
            "step": step,
            "keys": sorted(flat),
            "format": _FORMAT_V1,
            # One device per process: the two counts agree.
            "process_count": bootstrap.process_count(),
            "device_count": bootstrap.process_count(),
        }))
        _fire_write_fault(stage, step)
        _publish_stage(stage, target, directory, step)
    logger.info("checkpoint step %d written to %s", step, target)
    if max_to_keep is not None:
        _gc(directory, max_to_keep)
    return str(target)


def save(directory: str | os.PathLike, model_or_variables, *, step: int,
         max_to_keep: Optional[int] = None,
         sharded: bool = False) -> Optional[str]:
    """Write checkpoint ``step`` synchronously; returns its path on the
    chief, None elsewhere (v2: on every process). Takes a model (its live
    training variables) or a variables dict. v1: only the chief writes;
    every process meets at a barrier after the write, and a write error is
    raised after it, so no peer is left waiting. ``sharded=True``: the v2
    layout (module docstring). ``max_to_keep`` keeps that many newest
    steps."""
    t0 = time.perf_counter()
    directory = pathlib.Path(directory)
    try:
        if sharded:
            return _save_sharded(directory, _v2_parts(model_or_variables),
                                 step=step, max_to_keep=max_to_keep)
        saveable = _saveable(model_or_variables)
        path = None
        write_error: Optional[OSError] = None
        if bootstrap.is_chief():
            try:
                flat = {k: _host(v) for k, v in saveable.items()}
                path = _write_v1_checkpoint(directory, flat, step=step,
                                            max_to_keep=max_to_keep)
            except OSError as exc:
                write_error = exc
        bootstrap.barrier(f"checkpoint_save_{step}")
        if write_error is not None:
            raise write_error
        return path
    finally:
        metrics_lib.inc("checkpoint.sync_saves")
        metrics_lib.observe_value("checkpoint.stall_s",
                                  time.perf_counter() - t0)


# -- the sharded v2 layout ---------------------------------------------------------

class _V2Parts:
    """What one process writes of a v2 step: ``local``, its blocks keyed
    ``{key}//0``, with their ``index`` entries; ``chief``, the replicated
    leaves (on the chief only); ``meta``, the manifest's leaves."""

    def __init__(self):
        self.local: dict = {}
        self.index: dict = {}
        self.chief: dict = {}
        self.meta: dict = {}

    def tensors(self) -> dict:
        return {**self.local, **self.chief}


def _owns_block(shard) -> bool:
    """True when this process writes its block of a leaf placed along
    ``shard``'s axis: of the processes holding the same block, the one at
    coordinate 0 of every other axis of the mesh."""
    from tpu_dist_torch.parallel import mesh as mesh_lib

    mesh = shard.mesh
    return all(mesh_lib.coordinate(mesh, a) == 0 for a in mesh.axis_names
               if a != shard.axis)


def _v2_parts(model_or_variables) -> _V2Parts:
    """This process's part of a v2 step, its blocks as they live (no
    gather); a variables dict's leaves are all replicated."""
    from tpu_dist_torch.models.model import Model

    parts = _V2Parts()
    chief = bootstrap.is_chief()
    layout: dict = {}
    if isinstance(model_or_variables, Model):
        model = model_or_variables
        live = _live_tensors(model, gathered=False)
        trainer = model._trainer
        layout = _shard_layout(model, trainer)
        names = bridge.checkpoint_names(model, trainer.variables["opt"])
        owners = model._tensor_parallel[2] if layout else {}
    else:
        live = _saveable(model_or_variables)
    for key, t in live.items():
        placed = layout.get(key)
        parts.meta[key] = {"shape": list(_global_shape(t, placed)),
                           "dtype": str(_np_dtype(t)),
                           "sharded": placed is not None}
        if placed is None:
            if chief:
                parts.chief[key] = t
            continue
        if not _owns_block(owners[names[key]]):
            continue
        dim, _, index = placed
        name = f"{key}//0"
        parts.local[name] = t
        parts.index[key] = [{"name": name, "slices": [
            [index * n, (index + 1) * n] if d == dim else [0, n]
            for d, n in enumerate(t.shape)]}]
    return parts


def _write_sharded_stage(stage: pathlib.Path, parts: _V2Parts,
                         arrays: dict, *, step: int) -> None:
    """This process's files of a v2 stage from host ``arrays`` (keyed as
    ``parts.tensors()``): its shard npz and index, and on the chief the
    replicated leaves and the manifest. No collective, no barrier, no
    fsync (the publish fsyncs the stage): the sync path calls it between
    its barriers, the async writer on its thread."""
    proc = bootstrap.process_index()
    np.savez(stage / _shard_arrays(proc),
             **{n: arrays[n] for n in parts.local})
    (stage / _shard_index(proc)).write_text(json.dumps(parts.index))
    if bootstrap.is_chief():
        np.savez(stage / _ARRAYS, **{k: arrays[k] for k in parts.chief})
        (stage / _MANIFEST).write_text(json.dumps({
            "step": step,
            "format": _FORMAT_V2,
            "process_count": bootstrap.process_count(),
            "device_count": bootstrap.process_count(),
            "leaves": parts.meta,
        }))


def _make_stage(directory: pathlib.Path, step: int) -> pathlib.Path:
    """The chief clears and makes the step's stage (a crashed attempt may
    have left one); every process meets at ``checkpoint_stage_`` after."""
    stage = directory / f".stage-{step}"
    if bootstrap.is_chief():
        directory.mkdir(parents=True, exist_ok=True)
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir()
    bootstrap.barrier(f"checkpoint_stage_{step}")
    return stage


def _publish_sharded(directory: pathlib.Path, stage: pathlib.Path, step: int,
                     max_to_keep: Optional[int]) -> Optional[OSError]:
    """The chief's publish of a fully written v2 stage, behind the write
    fault hook; returns (not raises) a write error, the stage discarded."""
    try:
        _fire_write_fault(stage, step)
        _publish_stage(stage, _step_dir(directory, step), directory, step)
        logger.info("sharded checkpoint step %d written to %s (%d writers)",
                    step, _step_dir(directory, step),
                    bootstrap.process_count())
        if max_to_keep is not None:
            _gc(directory, max_to_keep)
    except OSError as exc:
        shutil.rmtree(stage, ignore_errors=True)
        return exc
    return None


def _save_sharded(directory: pathlib.Path, parts: _V2Parts, *, step: int,
                  max_to_keep: Optional[int]) -> str:
    stage = _make_stage(directory, step)
    _write_sharded_stage(stage, parts, {k: _host(v) for k, v in
                                        parts.tensors().items()}, step=step)
    bootstrap.barrier(f"checkpoint_written_{step}")
    write_error = None
    if bootstrap.is_chief():
        write_error = _publish_sharded(directory, stage, step, max_to_keep)
    bootstrap.barrier(f"checkpoint_save_{step}")
    if write_error is not None:
        raise write_error
    return str(_step_dir(directory, step))


# -- the async pipeline: snapshot now, write on a thread ----------------------------

class _Snapshot:
    """The values of a checkpoint's tensors at the moment it was taken. A
    CUDA tensor is cloned on the current stream, so the clone holds the
    value every step queued before it leaves and no later step can change
    it; the clones are copied into pinned host memory on a side stream,
    behind an event, while the next steps run. CPU tensors and arrays are
    copied at once. :meth:`arrays` waits for the copies (on the writer's
    thread)."""

    def __init__(self, saveable: dict):
        self._host: dict = {}
        self._done: Optional[torch.cuda.Event] = None
        cuda = {k: v for k, v in saveable.items()
                if isinstance(v, torch.Tensor) and v.is_cuda}
        for key, value in saveable.items():
            if key not in cuda:
                self._host[key] = _host(value).copy()
        if not cuda:
            return
        clones = {k: v.detach().clone() for k, v in cuda.items()}
        taken = torch.cuda.Event()
        taken.record()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            side.wait_event(taken)
            for key, c in clones.items():
                pinned = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                pinned.copy_(c, non_blocking=True)
                self._host[key] = pinned
            self._done = torch.cuda.Event()
            self._done.record(side)
        # The clones stay referenced until the copies are done.
        self._clones = clones

    def arrays(self) -> dict:
        if self._done is not None:
            self._done.synchronize()
            self._clones = None
        return {k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in self._host.items()}


class AsyncCheckpointer:
    """Checkpoints whose serialization, fsync and publish run on a
    background thread while training goes on (the reference's
    ``AsyncCheckpointer``).

    ``save_async(model, step=N)`` first commits the previous save (joins
    its writer, meets the other processes at a barrier) and then takes a
    :class:`_Snapshot` of step N and hands it to a new writer thread. The
    reference's arrays are immutable; the port's step updates parameters in
    place, so the snapshot clones them on the compute stream before the
    next step is queued. At most one save is in flight; :meth:`wait` and
    :meth:`close` are the other commit points. A write error surfaces at
    the next commit point, tagged with ``exc.checkpoint_step``, after the
    barrier (from ``save_async`` after the new snapshot is in flight), so
    one failed write costs one checkpoint, not the run. v1: only the chief
    has a writer. v2 (``sharded=True``): every process writes its part on
    its own writer, after the ``checkpoint_stage_`` barrier, and the
    chief publishes on the main thread at the commit, once a sum of
    failure flags over the processes says every part landed. A writer
    joins no collective and no barrier."""

    def __init__(self, directory: str | os.PathLike, *,
                 max_to_keep: Optional[int] = None, sharded: bool = False):
        self.directory = pathlib.Path(directory)
        self.max_to_keep = max_to_keep
        self.sharded = sharded
        self._thread: Optional[threading.Thread] = None
        self._pending_step: Optional[int] = None
        self._error: Optional[BaseException] = None  # writer -> commit
        self._last_path: Optional[str] = None

    @property
    def in_flight_step(self) -> Optional[int]:
        """The step being written, or None when drained."""
        return self._pending_step

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._drain()  # already unwinding: keep the original error

    def save_async(self, model_or_variables, *, step: int) -> None:
        """Commit the previous save, snapshot the current state and hand it
        to a writer thread; raises the previous save's error, if any, once
        the new snapshot is in flight."""
        t0 = time.perf_counter()
        prev_error = self._drain()
        if self.sharded:
            parts = _v2_parts(model_or_variables)
            stage = _make_stage(self.directory, step)
            t_snap = time.perf_counter()
            self._pending_step = step
            self._spawn(self._write_sharded,
                        _Snapshot(parts.tensors()), parts, stage, step)
        else:
            saveable = _saveable(model_or_variables)
            t_snap = time.perf_counter()
            self._pending_step = step
            if bootstrap.is_chief():
                self._spawn(self._write, _Snapshot(saveable), step)
        now = time.perf_counter()
        metrics_lib.inc("checkpoint.async_saves")
        metrics_lib.observe_value("checkpoint.snapshot_s", now - t_snap)
        metrics_lib.observe_value("checkpoint.stall_s", now - t0)
        if prev_error is not None:
            raise prev_error

    def wait(self) -> Optional[str]:
        """Commit point: join the writer, meet at the barrier, raise any
        stored error. Returns the last published path (the chief's)."""
        error = self._drain()
        if error is not None:
            raise error
        return self._last_path

    def close(self) -> Optional[str]:
        """Drain and commit (the checkpointer stays usable)."""
        return self.wait()

    def _spawn(self, fn, *args) -> None:
        self._thread = threading.Thread(
            target=fn, args=args, daemon=True,
            name=f"tpu-dist-ckpt-writer-{args[-1]}")
        self._thread.start()

    def _write_sharded(self, snapshot: _Snapshot, parts: _V2Parts,
                       stage: pathlib.Path, step: int) -> None:
        t0 = time.perf_counter()
        try:
            _write_sharded_stage(stage, parts, snapshot.arrays(), step=step)
        except Exception as exc:  # delivered at the next commit point
            self._error = exc  # shardcheck: disable=SC401 -- handoff attr; _drain joins before touching it
        finally:
            metrics_lib.observe_value("checkpoint.write_s",
                                      time.perf_counter() - t0)

    def _commit_sharded(self, step: int, error: Optional[BaseException]
                        ) -> Optional[BaseException]:
        """Publish a v2 step only when every process staged its part: the
        sum of the failure flags over the processes, then the chief's
        publish (behind the write fault hook). A failing process raises
        its own error; the chief withholds the publish."""
        from tpu_dist_torch.parallel.collectives import host_all_reduce_sum

        stage = self.directory / f".stage-{step}"
        bad = int(host_all_reduce_sum(np.int64(0 if error is None else 1)))
        if bootstrap.is_chief():
            if bad:
                shutil.rmtree(stage, ignore_errors=True)
            else:
                error = _publish_sharded(self.directory, stage, step,
                                         self.max_to_keep) or error
                if error is None:
                    self._last_path = str(_step_dir(self.directory, step))
        return error

    def _write(self, snapshot: _Snapshot, step: int) -> None:
        # _last_path and _error are handed over: _drain joins this thread
        # before it reads them.
        t0 = time.perf_counter()
        try:
            self._last_path = _write_v1_checkpoint(  # shardcheck: disable=SC401 -- handoff attr; _drain joins before touching it
                self.directory, snapshot.arrays(), step=step,
                max_to_keep=self.max_to_keep)
        except Exception as exc:  # delivered at the next commit point
            self._error = exc
        finally:
            metrics_lib.observe_value("checkpoint.write_s",
                                      time.perf_counter() - t0)

    def _drain(self) -> Optional[BaseException]:
        """Join the writer and meet at the commit barrier; return (not
        raise) the stored error."""
        if self._pending_step is None:
            return None
        step, self._pending_step = self._pending_step, None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if self.sharded:
            error = self._commit_sharded(step, error)
        bootstrap.barrier(f"checkpoint_commit_{step}")
        if error is not None:
            metrics_lib.inc("checkpoint.write_errors")
            error.checkpoint_step = step
            logger.warning("async checkpoint step %d failed: %s", step, error)
        return error


# -- listing and validation --------------------------------------------------------

def _manifest(target: pathlib.Path) -> dict:
    mf = target / _MANIFEST
    if mf.is_file():
        try:
            return json.loads(mf.read_text())
        except ValueError:
            pass
    return {}


def _gc(directory: pathlib.Path, max_to_keep: int) -> None:
    steps = sorted(all_steps(directory))
    for old in steps[:-max_to_keep]:
        shutil.rmtree(_step_dir(directory, old), ignore_errors=True)


def all_steps(directory: str | os.PathLike) -> list[int]:
    """Every ``ckpt-<step>`` directory's step, ascending."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for child in directory.iterdir():
        if child.is_dir() and child.name.startswith("ckpt-"):
            try:
                out.append(int(child.name.split("-", 1)[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    """The pointer's step, else the newest step directory, else None."""
    directory = pathlib.Path(directory)
    pointer = directory / _POINTER
    if pointer.is_file():
        try:
            return int(pointer.read_text().strip())
        except ValueError:
            pass
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _npz_names(path: pathlib.Path) -> Optional[set]:
    """The member names of an npz, or None when it cannot be read (a
    truncated write leaves a zip without its central directory)."""
    try:
        with np.load(path) as z:
            return set(z.files)
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


def validate_step_dir(target: str | os.PathLike) -> Optional[str]:
    """Why the step directory ``target`` is not safe to restore from, or
    None when it is: the manifest parses, the arrays open, and their keys
    are the manifest's. Structural, not a content hash: the threat is a
    write cut short where the atomic publish was subverted."""
    target = pathlib.Path(target)
    if not target.is_dir():
        return "missing checkpoint directory"
    mf = target / _MANIFEST
    if not mf.is_file():
        return "missing manifest.json"
    try:
        manifest = json.loads(mf.read_text())
    except ValueError:
        return "manifest.json does not parse"
    fmt = manifest.get("format")
    if fmt == _FORMAT_V1:
        names = _npz_names(target / _ARRAYS)
        if names is None:
            return f"{_ARRAYS} is unreadable (truncated write?)"
        keys = manifest.get("keys")
        if keys is not None and set(keys) != names:
            missing = sorted(set(keys) - names)[:3]
            return (f"{_ARRAYS} does not match manifest keys "
                    f"(e.g. missing {missing})")
        return None
    if fmt == _FORMAT_V2:
        if _npz_names(target / _ARRAYS) is None:
            return f"chief {_ARRAYS} is unreadable (truncated write?)"
        for idx_file in sorted(target.glob("shards-*.json")):
            try:
                json.loads(idx_file.read_text())
            except ValueError:
                return f"{idx_file.name} does not parse"
            arr = target / idx_file.name.replace(
                "shards-", "arrays-shard-").replace(".json", ".npz")
            if _npz_names(arr) is None:
                return f"{arr.name} is unreadable (truncated write?)"
        return None
    return f"unknown checkpoint format {fmt!r}"


def _iter_sharded_leaves(target: pathlib.Path):
    """``(key, assemble)`` for every leaf of the v2 step ``target``;
    ``assemble()`` stitches that one leaf's global array from the shard
    indices (the chief's npz for a replicated leaf). Raises on a leaf with
    no shards, on a shard whose data disagrees with its index's slices,
    and on shards that do not cover the array (a missing process's
    file)."""
    manifest = _manifest(target)
    indices: dict = {}
    files: dict = {}
    for idx_file in sorted(target.glob("shards-*.json")):
        arr_file = target / idx_file.name.replace(
            "shards-", "arrays-shard-").replace(".json", ".npz")
        for key, entries in json.loads(idx_file.read_text()).items():
            for e in entries:
                e["file"] = str(arr_file)
            indices.setdefault(key, []).extend(entries)

    def load(fname, name):
        z = files.get(fname)
        if z is None:
            z = files[fname] = np.load(fname)
        return z[name]

    for key, meta in manifest["leaves"].items():
        if not meta["sharded"]:
            yield key, (lambda k=key: load(str(target / _ARRAYS), k))
            continue

        def assemble(k=key, m=meta):
            entries = indices.get(k)
            if not entries:
                raise FileNotFoundError(
                    f"sharded checkpoint {target} has no shards for {k!r} "
                    "— were all processes' shard files on this "
                    "filesystem? (v2 checkpoints require a shared FS)")
            out = np.zeros(tuple(m["shape"]), np.dtype(m["dtype"]))
            filled = 0
            for e in entries:
                data = load(e["file"], e["name"])
                want = tuple(b - a for a, b in e["slices"])
                if tuple(data.shape) != want:
                    raise ValueError(
                        f"sharded checkpoint {target}: shard {e['name']!r} "
                        f"of {k!r} has shape {tuple(data.shape)} but its "
                        f"index claims slices {e['slices']} ({want}); "
                        "refusing to assemble a torn state")
                out[tuple(slice(a, b) for a, b in e["slices"])] = data
                filled += data.size
            if filled != out.size:
                raise ValueError(
                    f"sharded checkpoint {target}: shards for {k!r} cover "
                    f"{filled} of {out.size} elements — missing shard "
                    "files (v2 checkpoints require a shared FS)")
            return out

        yield key, assemble



def is_complete(directory: str | os.PathLike, step: int) -> bool:
    return validate_step_dir(_step_dir(pathlib.Path(directory), step)) is None


def latest_complete_step(directory: str | os.PathLike, *,
                         before: Optional[int] = None) -> Optional[int]:
    """The newest step that passes :func:`validate_step_dir`, the resume
    anchor: the pointer is a hint, and a corrupt step costs one interval,
    never the run. ``before`` keeps only steps strictly earlier."""
    directory = pathlib.Path(directory)
    pointed = latest_step(directory)
    if before is not None and pointed is not None and pointed >= before:
        pointed = None
    if pointed is not None and is_complete(directory, pointed):
        return pointed
    for step in reversed(all_steps(directory)):
        if before is not None and step >= before:
            continue
        if step == pointed:
            continue  # already rejected above
        reason = validate_step_dir(_step_dir(directory, step))
        if reason is None:
            if pointed is not None:
                logger.warning(
                    "checkpoint step %s is incomplete (%s); resuming from "
                    "step %d instead", pointed,
                    validate_step_dir(_step_dir(directory, pointed)), step)
            return step
        logger.warning("skipping incomplete checkpoint step %d: %s",
                       step, reason)
    return None


# -- restore ---------------------------------------------------------------------

def _chief_choice(value: int) -> int:
    """The chief's ``value`` on every process."""
    from tpu_dist_torch.parallel.collectives import broadcast_from_chief

    return int(broadcast_from_chief(np.int64(value)))


def restore(directory: str | os.PathLike, template: dict, *,
            step: Optional[int] = None) -> tuple[dict, int]:
    """The arrays of checkpoint ``step`` (default: the latest complete one)
    for the keys of ``template`` (``{key: tensor or array}``, whose shapes
    they must have; keys the checkpoint holds beyond them are left out).
    Returns ``({key: numpy array}, step)``. The chief chooses the step
    and validates it. v1: the chief reads it and its bytes are broadcast
    to every process, which need not see the files. v2: every process
    stitches the global arrays from the shard files itself (a shared
    filesystem, by the layout's contract)."""
    directory = pathlib.Path(directory)
    many = bootstrap.process_count() > 1
    chief = bootstrap.process_index() == 0
    if step is None:
        local = latest_complete_step(directory) if chief else None
        step = local if not many else _chief_choice(
            -1 if local is None else local)
        if step is not None and step < 0:
            step = None
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoints under {directory}")
    target = _step_dir(directory, step)
    # Verdict: -1 invalid, 0 v1, 1 v2; the chief's, on every process, so
    # no process takes the v1 broadcast alone.
    reason = validate_step_dir(target) if chief else None
    verdict = -1 if reason is not None else (
        int(_manifest(target).get("format") == _FORMAT_V2) if chief else 0)
    if many:
        verdict = _chief_choice(verdict)
    if verdict < 0:
        raise ValueError(
            f"checkpoint step {step} at {target} failed validation"
            + (f": {reason}" if reason else "")
            + "; refusing to restore from an incomplete checkpoint")
    shapes = {k: (tuple(np.shape(v)), _np_dtype(v))
              for k, v in template.items()}
    if verdict == 1:
        leaves = dict(_iter_sharded_leaves(target))
        arrays = {}
        for key, (shape, _) in shapes.items():
            if key not in leaves:
                raise KeyError(f"checkpoint missing array {key!r}; "
                               "checkpoint/model mismatch")
            arr = leaves[key]()
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"checkpoint array {key!r} has shape {arr.shape}, "
                    f"model expects {shape}")
            arrays[key] = arr
        logger.info("restored sharded checkpoint step %d from %s", step,
                    target)
        return arrays, step
    if chief:
        with np.load(target / _ARRAYS) as z:
            arrays = {}
            for key, (shape, _) in shapes.items():
                if key not in z.files:
                    raise KeyError(f"checkpoint missing array {key!r}; "
                                   "checkpoint/model mismatch")
                arr = z[key]
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"checkpoint array {key!r} has shape {arr.shape}, "
                        f"model expects {shape}")
                arrays[key] = arr
    else:
        arrays = {k: np.zeros(shape, dtype) for k, (shape, dtype)
                  in shapes.items()}
    if many:
        from tpu_dist_torch.parallel.collectives import broadcast_from_chief

        arrays = broadcast_from_chief(arrays)
    logger.info("restored checkpoint step %d from %s", step, target)
    return arrays, step


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def restore_model(directory: str | os.PathLike, model, *,
                  step: Optional[int] = None, trainer=None) -> int:
    """Restore a model's training variables in place (resume): its
    parameters, its state buffers and the optimizer state of ``trainer``
    (default: the model's own, made if it has none), each ``copy_``-ed on
    its device from the checkpoint (module docstring); under a model axis
    each process copies its block of each sharded leaf, whatever the
    topology that wrote it. Returns the step."""
    live = _live_tensors(model, trainer, gathered=False)
    trainer = trainer or model._trainer
    layout = _shard_layout(model, trainer)
    template = {k: torch.empty(_global_shape(t, layout.get(k)),
                               dtype=t.dtype, device="meta")
                for k, t in live.items()}
    arrays, step = restore(directory, template, step=step)
    target = _step_dir(pathlib.Path(directory), step)
    sharded_keys = {k for k, m in _manifest(target).get("leaves", {}).items()
                    if m.get("sharded")}
    _check_divisible_placement(model, trainer, sharded_keys, layout, live)
    _note_reshape(pathlib.Path(directory), step)
    with torch.no_grad():
        for key, t in live.items():
            value = torch.from_numpy(arrays[key])
            if key in layout:
                dim, size, index = layout[key]
                per = value.shape[dim] // size
                value = value.narrow(dim, index * per, per)
            t.copy_(value)
    return step


def _global_shape(t: torch.Tensor, placed) -> tuple:
    """The global shape of a live tensor, a block along ``dim`` of ``size``
    when ``placed`` is ``(dim, size, index)``."""
    shape = list(t.shape)
    if placed is not None:
        shape[placed[0]] *= placed[1]
    return tuple(shape)


def _unpruned_specs(model, mesh) -> dict:
    """``{parameter name: spec}`` the rules give each parameter on
    ``mesh`` before an indivisible dimension is left replicated: the model
    axis's Megatron specs, a pipelined stack's ``(pipe,)``, an expert
    layer's ``(expert,)``."""
    from tpu_dist_torch.models.model import _flatten, _nest
    from tpu_dist_torch.parallel.axes import MODEL_AXIS
    from tpu_dist_torch.parallel.expert import MixtureOfExperts
    from tpu_dist_torch.parallel.pipeline_parallel import PipelinedBlocks
    from tpu_dist_torch.parallel.tensor import tensor_parallel_specs

    specs: dict = {}
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        specs.update(_flatten(tensor_parallel_specs(
            _nest(model.named_parameters()), axis_name=MODEL_AXIS)))
    for prefix, m in model.named_modules():
        if isinstance(m, (PipelinedBlocks, MixtureOfExperts)):
            for n, _ in m.named_parameters():
                if n != "router":
                    specs[f"{prefix}.{n}" if prefix else n] = (m.axis_name,)
    return specs


def _check_divisible_placement(model, trainer, sharded_keys: set,
                               layout: dict, live: dict) -> None:
    """Refuse a reshape-restore that would silently degrade placement: a
    leaf the checkpoint stored sharded, which the restoring mesh's rules
    would shard along an axis it has, but whose dimension that axis does
    not divide (so the restoring model holds it replicated). A leaf the
    saving job already replicated, an axis the mesh lacks, and v1 steps
    (no per-leaf record) pass."""
    mesh = trainer.strategy.parallel_mesh
    if mesh is None or not sharded_keys:
        return
    specs = _unpruned_specs(model, mesh)
    names = bridge.checkpoint_names(model, trainer.variables["opt"])
    for key in sorted(sharded_keys):
        if key in layout or key not in live:
            continue  # placed as a block: divides by construction
        shape = tuple(live[key].shape)
        for dim, axis in enumerate(specs.get(names.get(key)) or ()):
            if axis is None or axis not in mesh.shape:
                continue
            div = mesh.shape[axis]
            if dim < len(shape) and shape[dim] % div:
                raise ValueError(
                    f"cannot reshape-restore {key}: dimension {dim} of "
                    f"shape {shape} does not divide mesh axis {axis!r} "
                    f"(size {div}) — relaunch with a worker/device count "
                    "whose axis sizes divide every sharded dimension, or "
                    "restore on the original topology")


def _note_reshape(directory: pathlib.Path, step: int) -> None:
    """Count and record a topology-changing restore from the manifest's
    stamp (``elastic.reshape_restores``, a ``reshape_restore`` event);
    never fails the restore."""
    try:
        manifest = _manifest(_step_dir(directory, step))
        saved_procs = manifest.get("process_count")
        saved_devs = manifest.get("device_count")
        now = bootstrap.process_count()
        if not ((saved_procs is not None and saved_procs != now)
                or (saved_devs is not None and saved_devs != now)):
            return
        metrics_lib.inc("elastic.reshape_restores")
        logger.info("reshape-restore of step %d: saved on %s process(es) / "
                    "%s device(s), restoring on %d / %d", step, saved_procs,
                    saved_devs, now, now)
        from tpu_dist_torch.resilience import events

        events.maybe_log("reshape_restore", step=step,
                         saved_process_count=saved_procs,
                         saved_device_count=saved_devs,
                         process_count=now, device_count=now)
    except OSError:
        pass
