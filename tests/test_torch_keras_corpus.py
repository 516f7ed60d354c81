"""The port's Keras importer against the JAX package's on the
``fam_keras_*`` families of ``tests/test_import_corpus.py`` (legacy .h5
and Keras 3 ``.keras`` zips, Sequential and Functional), each held to
the JAX net and to Keras's ``predict`` at the family's tolerance, and on
the committed Keras ResNet50 config (``tests/torch_keras_resnet50.json``)
written at 64×64 by ``chip_smoke.py``'s HDF5 writer (the two importers
agree at B2 within 1e-4; ``ZooModel.init_pretrained`` routes the file).
The shared helpers are ``tests/test_torch_keras_import.py``'s."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
pytest.importorskip("h5py")

from test_torch_keras_import import _both, _check, _out  # noqa: E402

torch.set_num_threads(2)
keras = tf.keras
ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------ the import corpus families

def _fam_dense():
    return keras.Sequential([
        keras.layers.Input((8,)),
        keras.layers.Dense(16, activation="relu"),
        keras.layers.Dense(4, activation="softmax")]), (3, 8), "h5", 1e-5


def _fam_conv():
    return keras.Sequential([
        keras.layers.Input((8, 8, 2)),
        keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(3, activation="softmax")]), (2, 8, 8, 2), "h5", \
        1e-4


def _fam_lstm():
    return keras.Sequential([
        keras.layers.Input((5, 6)),
        keras.layers.LSTM(8, return_sequences=False),
        keras.layers.Dense(3)]), (2, 5, 6), "h5", 1e-4


def _fam_functional(merge):
    inp = keras.layers.Input((8,))
    a = keras.layers.Dense(8, activation="relu")(inp)
    b = keras.layers.Dense(8, activation="tanh")(inp)
    out = keras.layers.Dense(3, activation="softmax")(merge()([a, b]))
    return keras.Model(inp, out), (3, 8)


def _fam_v3_sequential():
    return keras.Sequential([
        keras.layers.Input((8, 8, 2)),
        keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D(2),
        keras.layers.Conv2D(8, 3),
        keras.layers.Flatten(),
        keras.layers.Dense(3, activation="softmax")]), (2, 8, 8, 2), \
        "keras", 1e-4


FAMILIES = {
    "keras_dense": _fam_dense, "keras_conv": _fam_conv,
    "keras_lstm": _fam_lstm,
    "keras_functional": lambda: (*_fam_functional(keras.layers.Add), "h5",
                                 1e-5),
    "keras_v3_sequential": _fam_v3_sequential,
    "keras_v3_functional": lambda: (
        *_fam_functional(keras.layers.Concatenate), "keras", 1e-5),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_corpus_keras_family(family, tmp_path):
    m, shape, ext, atol = FAMILIES[family]()
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    how = "sequential" if isinstance(m, keras.Sequential) else "model"
    _check(m, tmp_path / f"{family}.{ext}", x, atol, how=how)


# ------------------------------------------------------------ ResNet50 file

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_keras", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keras_resnet50_file_imports_alike_and_routes(tmp_path):
    """chip_smoke's ResNet50 file at 64×64: the two importers agree at B2
    (1e-4) on a graph of 53 BNs; ``init_pretrained`` of the .h5 returns
    the imported net (a ComputationGraph, routed by its class name)."""
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization
    from deeplearning4j_tpu_torch.zoo import ResNet50
    cs = _chip_smoke()
    path = tmp_path / "resnet50.h5"
    cs.write_keras_resnet50(path, hw=64)
    jnet, tnet = _both(path, how="model")
    assert sum(isinstance(d.op, BatchNormalization)
               for d in tnet.conf.nodes.values()) == 53
    assert tnet.conf.topo_order == jnet.conf.topo_order
    x = np.random.default_rng(20).random((2, 64, 64, 3)).astype(np.float32)
    got_t, got_j = _out(tnet, x), _out(jnet, x)
    np.testing.assert_allclose(got_t, got_j, atol=1e-4)
    assert got_t.shape == (2, 1000)
    routed = ResNet50(num_classes=1000, input_shape=(64, 64, 3)) \
        .init_pretrained(path, device="cpu")
    assert isinstance(routed, ComputationGraph)
    np.testing.assert_array_equal(_out(routed, x), got_t)
