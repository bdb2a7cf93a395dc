"""Saved models: the port's ``models/serialize.py`` against the JAX
package's, on the CPU.

``model.json`` is the reference's, key for key and value for value, for
the CNN (compiled as the reference program compiles it), ResNet-18 and a
small LM (compiled with Adam). A directory the JAX package saved loads in
the port (``load_model``) and predicts within 1e-5 of the reference, with
its compile config and optimizer; one the port saved loads in the JAX
package the same way. A small LM the JAX package saved serves the
reference's greedy streams through ``ServeEngine.from_saved`` and through
``python -m tpu_dist_torch.serve --model-dir D --device cpu``.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.models import resnet as jresnet
from tpu_dist.models import serialize as jserialize
from tpu_dist.models import transformer as jtr
from tpu_dist.ops import optimizers as jopt
from tpu_dist.ops import schedules as jsched
from tpu_dist.serve import cli as jcli
from tpu_dist.serve.engine import ServeEngine as JServeEngine
from tpu_dist_torch.models import (Sequential, cnn, layers, load_model,
                                   resnet, save_model, serialize)
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.ops import optimizers, schedules
from tpu_dist_torch.serve import cli
from tpu_dist_torch.serve.engine import ServeEngine

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, SEQ = 32, 32


def _lm_pair():
    jm = jtr.build_transformer_lm(VOCAB, SEQ, d_model=16, depth=2,
                                  num_heads=2)
    tm = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, depth=2,
                                 num_heads=2)
    jm.compile(optimizer=jopt.Adam(0.001),
               loss="sparse_categorical_crossentropy")
    tm.compile(optimizer=optimizers.Adam(0.001),
               loss="sparse_categorical_crossentropy", device="cpu")
    return jm, tm


def _narrow_pair():
    def stack(L, R):
        return [*R._conv_bn(4, 3), R._stage(R._basic_block, 4, 1, 2, True),
                L.GlobalAveragePooling2D(), L.Dense(10)]

    jm = jmodel_lib.Sequential(stack(jlayers, jresnet), input_shape=(8, 8, 1),
                               name="narrow_resnet")
    tm = Sequential(stack(layers, resnet), input_shape=(8, 8, 1),
                    name="narrow_resnet")
    sched = (jsched.ExponentialDecay(0.1, 10, 0.9),
             schedules.ExponentialDecay(0.1, 10, 0.9))
    jm.compile(optimizer=jopt.SGD(sched[0], momentum=0.9),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    tm.compile(optimizer=optimizers.SGD(sched[1], momentum=0.9),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"],
               device="cpu")
    return jm, tm


def _cnn_pair():
    jm = jcnn.build_and_compile_cnn_model()
    tm = cnn.build_and_compile_cnn_model(device="cpu")
    return jm, tm


PAIRS = {"cnn": _cnn_pair, "narrow_resnet": _narrow_pair, "lm": _lm_pair}


@pytest.mark.parametrize("name", list(PAIRS))
def test_model_json_is_the_references(name):
    jm, tm = PAIRS[name]()
    assert serialize.model_config(tm) == jserialize.model_config(jm)


def test_resnet18_model_json_is_the_references():
    want = jserialize.model_config(jresnet.ResNet18(input_shape=(28, 28, 1)))
    got = serialize.model_config(resnet.ResNet18(input_shape=(28, 28, 1)))
    assert got == want


def _inputs(name, rows=4):
    rng = np.random.default_rng(5)
    if name == "lm":
        return rng.integers(0, VOCAB, size=(rows, SEQ))
    shape = (28, 28, 1) if name == "cnn" else (8, 8, 1)
    return rng.random((rows, *shape), dtype=np.float32)


@pytest.mark.parametrize("name", list(PAIRS))
def test_saved_models_load_across_the_packages(name, tmp_path):
    jm, tm = PAIRS[name]()
    x = _inputs(name)
    labels = np.zeros(x.shape[:2] if name == "lm" else len(x), np.int64)
    # Trained a step, so the optimizer and BatchNorm state are not fresh.
    jm.fit((x, labels), epochs=1, verbose=0)
    jm.save(str(tmp_path / "jax"))
    got = load_model(tmp_path / "jax", device="cpu")
    assert got.optimizer is not None and type(got.optimizer).__name__ == \
        type(jm.optimizer).__name__
    np.testing.assert_allclose(got.predict(x), np.asarray(jm.predict(x)),
                               **TOL)
    # ... and the port's save of it loads in the JAX package.
    got.save(tmp_path / "port")
    assert json.loads((tmp_path / "port" / "model.json").read_text()) == \
        json.loads((tmp_path / "jax" / "model.json").read_text())
    back = jserialize.load_model(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(back.predict(x)), got.predict(x),
                               **TOL)
    # Uncompiled, the model stays as saved.
    bare = load_model(tmp_path / "port", compile=False, device="cpu")
    assert bare.optimizer is None
    np.testing.assert_allclose(bare.predict(x), got.predict(x), **TOL)
    save_model(bare, tmp_path / "bare")
    assert "compile" not in json.loads(
        (tmp_path / "bare" / "model.json").read_text())


def test_a_callable_field_and_unknown_classes_refuse_to_serialize():
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, depth=1,
                                    num_heads=2)
    for m in model.modules():
        if isinstance(m, tr.MultiHeadAttention):
            m.attention_fn = tr._dense_attention
    with pytest.raises(TypeError, match="callable"):
        serialize.model_config(model)
    with pytest.raises(ValueError, match="unknown layer class"):
        serialize.layer_from_config({"class": "Sequential", "config": {}})
    with pytest.raises(TypeError, match="Sequential"):
        serialize.model_config(torch.nn.Linear(2, 2))


def _jax_saved_lm(tmp_path):
    jm = jtr.build_transformer_lm(VOCAB, SEQ, d_model=16, depth=2,
                                  num_heads=2)
    jm.compile(optimizer=jopt.Adam(0.001),
               loss="sparse_categorical_crossentropy")
    rng = np.random.default_rng(2)
    x = rng.integers(0, VOCAB, size=(4, SEQ))
    jm.fit((x, x), epochs=1, verbose=0)
    jm.save(str(tmp_path / "lm"))
    return str(tmp_path / "lm")


def test_a_jax_saved_lm_serves_the_references_streams(tmp_path):
    directory = _jax_saved_lm(tmp_path)
    jeng = JServeEngine.from_saved(directory, max_batch=4)
    eng = ServeEngine.from_saved(directory, max_batch=4, device="cpu")
    assert eng.max_len == jeng.max_len == SEQ
    rng = np.random.default_rng(7)
    specs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), int(m))
             for n, m in zip(rng.integers(3, 13, size=6),
                             rng.integers(4, 11, size=6))]
    jreqs = [jeng.submit(p, max_new_tokens=m) for p, m in specs]
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in specs]
    jeng.run_until_idle()
    eng.run_until_idle()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == m for r, (_, m) in zip(reqs, specs))


def _streams(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return re.findall(r"-> (\[[^\]]*\])", out.getvalue())


def test_model_dir_cli_serves_the_references_streams(tmp_path):
    directory = _jax_saved_lm(tmp_path)
    argv = ["--model-dir", directory, "--vocab", str(VOCAB), "--max-len",
            str(SEQ), "--requests", "4"]
    want = _streams(jcli.main, argv)
    got = _streams(cli.main, [*argv, "--device", "cpu"])
    assert len(got) == 4 and got == want
    rc_out = io.StringIO()
    with contextlib.redirect_stdout(rc_out):
        rc = cli.main([*argv, "--device", "cpu", "--bench", "--max-new",
                       "6"])
    report = json.loads(rc_out.getvalue())
    assert rc == 0 and report["ok"] and report["completed"] == 4
