"""CUDA graphs: the port's counterpart of the reference's compiled programs.

Where the JAX package ``jax.jit``s a function once per static key (a
decode bucket, a prefill pad, K train steps under ``lax.scan``) and calls
the cached executable after that, the port records the function's CUDA
work once in a ``torch.cuda.CUDAGraph`` and replays it. A
:class:`CapturedProgram` holds:

* a static device buffer for each input and pinned host staging for it: a
  call writes the host values into the staging, copies them to the static
  buffers (non-blocking, on the current stream, the one a replay launches
  on) and runs;
* one capture into a memory pool that the programs of one owner share
  (``torch.cuda.graph_pool_handle()``). An intermediate of one graph may
  reuse memory that another graph freed: this is sound because replays run
  one at a time on one stream, and a replay's outputs are read before the
  next replay of any graph of the pool (or copied, as the trainer copies
  its loss);
* the capture's outputs, which every replay overwrites in place.

The first call runs the function eagerly on the static inputs, and that
run is the call's result: it is the warm-up (the kernels' libraries load,
the fused optimizers build their leaf tables, cuBLAS makes its handles)
and it changes state exactly as any later call does, so a training step is
not run twice and a KV write is not made twice. The second call captures
the function, which launches nothing, then replays it; every later call
replays. A key that is used once is never captured.

Replays launch the kernels without their Python wrappers, so the kernels'
launch counters would count only the eager calls. Every wrapper counts
through :func:`count_launch`: a launch on the stream a capture is
recording adds to that capture's record (the capturing thread's calls,
and the backward's, which autograd runs on a thread of its own but on the
forward's stream), and each replay adds the record; any other launch adds
one to its counter under a lock (several threads launch, as the replicas
of a serving fleet do), also while another thread captures.

Captures are serialised by one process-wide lock and run in the
thread-local capture mode, each on a side stream of its own: another
thread's eager work, replays, host reads and allocations go on during a
capture (they run on other streams, which the capture does not record),
and two captures never overlap. The cyclic garbage collector is off
while a capture records: a collection could destroy an old graph, whose
teardown on the capturing thread the capture does not permit (measured:
seen on an H100: it invalidated the capture).

Nothing falls back: a program is built only for a CUDA device, and an
error of the eager call, of the capture or of a replay propagates.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

_COUNT_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
#: (stream handle, record) of the capture under way, or None.
_CAPTURING: Optional[tuple] = None


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to the launch counter ``wrapper.<attr>``: into the record of
    the capture under way if this launch goes to the stream it records
    (each replay adds the record), else to the counter itself."""
    capturing = _CAPTURING
    with _COUNT_LOCK:
        if (capturing is not None and torch.cuda.current_stream()
                .cuda_stream == capturing[0]):
            record = capturing[1]
            record[(wrapper, attr)] = record.get((wrapper, attr), 0) + 1
            return
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


#: A static input: its shape and dtype.
Spec = tuple[tuple[int, ...], torch.dtype]


def _counters() -> list:
    """(wrapper, attribute) of every counter, imported at first need: this
    module is a leaf that no layer's import pulls the kernels through."""
    return [(getattr(importlib.import_module(module), fn), attr)
            for module, fn, attr in COUNTERS]


def spec_of(value) -> Spec:
    """The static buffer a host value needs: a numpy array's shape and
    dtype; an int a 0-d int64."""
    if isinstance(value, np.ndarray):
        return (tuple(value.shape),
                torch.from_numpy(np.empty(0, value.dtype)).dtype)
    if isinstance(value, (int, np.integer)):
        return (), torch.int64
    raise TypeError(f"a captured program takes numpy arrays and ints; got "
                    f"{type(value).__name__}")


class CapturedProgram:
    """``fn(**static_inputs)`` run eagerly once, then captured and
    replayed (module docstring).

    Args:
      fn: the function; it reads its inputs only from the keyword tensors
        it is given, which are the static buffers, and returns a tensor or
        a tuple of tensors.
      specs: ``{name: (shape, dtype)}`` of the inputs (:func:`spec_of`).
      device: a CUDA device; any other raises ``ValueError``.
      pool: the memory pool the owner's graphs share (``None``: a pool of
        this graph's own).
      generators: private CUDA generators ``fn`` draws from. The capture
        registers each (``CUDAGraph.register_generator_state``), so every
        replay advances its offset and draws fresh numbers, as the default
        generator's do.
    """

    def __init__(self, fn: Callable[..., Any], specs: dict[str, Spec], *,
                 device, pool=None, generators=()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"a captured program runs on a CUDA device, not {device}: a "
                "caller on the CPU calls the function itself")
        self.fn = fn
        self.static = {n: torch.zeros(shape, dtype=dt, device=device)
                       for n, (shape, dt) in specs.items()}
        self._staging = {n: torch.zeros(shape, dtype=dt, pin_memory=True)
                         for n, (shape, dt) in specs.items()}
        self._views = {n: t.numpy() for n, t in self._staging.items()}
        self._copied = torch.cuda.Event()
        self._pool = pool
        self._generators = tuple(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.calls = 0
        self.replays = 0
        #: Seconds the capture took (``None`` before it).
        self.capture_s: Optional[float] = None
        self._deltas: list = []

    def __call__(self, **inputs):
        """Load ``inputs`` (every input: numpy arrays or ints through the
        staging, tensors copied straight into the static buffer), then
        run: eagerly on the first call, capture and replay on the second,
        replay after that. A replay returns :attr:`outputs`, which the next
        replay of any graph of the pool may overwrite."""
        if inputs.keys() != self.static.keys():
            raise TypeError(f"a captured program takes {sorted(self.static)}"
                            f"; got {sorted(inputs)}")
        # The last call's copies must have read the staging.
        self._copied.synchronize()
        for name, value in inputs.items():
            buf = self.static[name]
            if isinstance(value, torch.Tensor):
                buf.copy_(value, non_blocking=True)
                continue
            self._views[name][...] = value
            buf.copy_(self._staging[name], non_blocking=True)
        self._copied.record()
        if self.calls == 0:
            out = self.fn(**self.static)
            self.calls = 1
            return out
        if self.graph is None:
            self._capture()
        self.calls += 1
        return self.replay()

    def _capture(self) -> None:
        """Record ``fn`` on a side stream (a capture cannot run on the
        default stream), under the process-wide capture lock and in the
        thread-local mode (module docstring). ``torch.cuda.graph`` would
        also empty the allocator's cache before each capture, which every
        eager allocation after it pays for again; a capture needs only the
        card idle."""
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        global _CAPTURING
        record: dict = {}
        stream = torch.cuda.Stream()
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            _CAPTURING = (stream.cuda_stream, record)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        outputs = self.fn(**self.static)
                    finally:
                        graph.capture_end()
            finally:
                _CAPTURING = None
                if collecting:
                    gc.enable()
            self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs = graph, outputs
        self._deltas = [(obj, attr, d) for (obj, attr), d in record.items()]

    def replay(self):
        """Replay the captured graph on the static inputs as they stand;
        adds the capture's counter deltas."""
        self.graph.replay()
        with _COUNT_LOCK:
            for obj, attr, d in self._deltas:
                setattr(obj, attr, getattr(obj, attr) + d)
        self.replays += 1
        return self.outputs
