"""The port's profiler hooks (``utils/profiler.py`` on ``torch.profiler``).

``trace`` writes one Chrome/TensorBoard trace into its directory (made if
missing) and counts ``profiler.traces`` when the metrics registry is on; a
process that is not the chief runs the span untraced and writes nothing;
``step_annotation`` is a null context outside a trace and a named span
inside one; ``annotate`` records ``span.<name>.s`` as the reference's
does; ``fit(profile_dir=)`` writes a trace with one step annotation per
execution and trains as a fit without it. The card's side (CUDA kernels
in the trace, captured programs inside one) is in ``test_torch_gpu.py``.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from tpu_dist.observe import metrics as jmetrics
from tpu_dist.utils import profiler as jprofiler
from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.utils import profiler


@pytest.fixture
def registry():
    """The port's and the reference's default registries, on and empty for
    the test, then as they were."""
    regs = (metrics.get_registry(), jmetrics.get_registry())
    was = [r.enabled for r in regs]
    for r in regs:
        r.reset()
        r.enable()
    yield regs[0]
    for r, on in zip(regs, was):
        r.reset()
        r.enabled = on


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_writes_into_logdir_and_counts(tmp_path, registry):
    logdir = tmp_path / "made" / "here"
    assert not profiler.is_active()
    with profiler.trace(logdir):
        assert profiler.is_active()
        with profiler.step_annotation(7):
            torch.ones(64).cumsum(0)
    assert not profiler.is_active()
    (trace,) = logdir.glob("*.pt.trace.json")
    names = {e.get("name") for e in _events(trace)}
    assert "train_step#7" in names
    assert registry.snapshot()["counters"] == {"profiler.traces": 1}


def test_a_process_that_is_not_the_chief_writes_nothing(tmp_path, registry,
                                                        monkeypatch):
    monkeypatch.setattr(bootstrap, "is_chief", lambda: False)
    with profiler.trace(tmp_path / "p"):
        assert not profiler.is_active()
        torch.ones(4).sum()
    assert not (tmp_path / "p").exists()
    assert registry.snapshot()["counters"] == {}
    with profiler.trace(tmp_path / "q", chief_only=False):
        assert profiler.is_active()
    assert list((tmp_path / "q").glob("*.pt.trace.json"))


def test_step_annotation_is_null_when_no_trace_is_active():
    assert isinstance(profiler.step_annotation(0), contextlib.nullcontext)
    assert isinstance(jprofiler.step_annotation(0), contextlib.nullcontext)


def test_annotate_records_the_span_as_the_reference_does(registry):
    for prof in (profiler, jprofiler):
        with prof.annotate("input"):
            pass
    for reg in (registry, jmetrics.get_registry()):
        span = reg.snapshot()["distributions"]["span.input.s"]
        assert span["count"] == 1 and span["min"] >= 0.0
    registry.disable()
    with profiler.annotate("input"):
        pass
    assert registry.snapshot()["distributions"]["span.input.s"]["count"] == 1


@pytest.mark.parametrize("k", [1, 2])
def test_fit_with_profile_dir_writes_a_trace_of_every_execution(tmp_path, k):
    rng = np.random.default_rng(0)
    x = rng.random((64, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 64)
    ds = Dataset.from_tensor_slices((x, y)).batch(16)
    runs = []
    for profile_dir in (None, tmp_path / "fit"):
        model = build_and_compile_cnn_model(device="cpu")
        model.compile(optimizer="sgd", loss=model.loss, steps_per_execution=k,
                      device="cpu")
        runs.append(model.fit(ds, epochs=2, steps_per_epoch=4, verbose=0,
                              profile_dir=profile_dir).history["loss"])
    assert runs[0] == runs[1]
    (trace,) = (tmp_path / "fit").glob("*.pt.trace.json")
    steps = sorted(e["name"] for e in _events(trace)
                   if e.get("name", "").startswith("train_step#"))
    assert steps == sorted(f"train_step#{i}" for i in range(0, 8, k))
