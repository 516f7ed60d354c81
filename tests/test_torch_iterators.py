"""The port's data iterators (``deeplearning4j_tpu_torch/data/iterators.py``)
against the JAX package's (``deeplearning4j_tpu/data/iterators.py``) on
the CPU: for the same seed, and for the same local files, every ported
iterator yields the reference's arrays batch by batch (exactly: both are
numpy), and ``KFoldIterator`` gives the same folds. Nothing is
downloaded: the files are written into a temporary ``DATA_HOME``.
"""

from __future__ import annotations

import gzip

import numpy as np
import pytest

import deeplearning4j_tpu.data.iterators as jit
import deeplearning4j_tpu_torch.data.iterators as tit
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet


def _batches(it):
    out = []
    for ds in it:
        out.append([None if a is None else np.asarray(a) for a in (
            ds.features, ds.labels, ds.features_mask, ds.labels_mask)])
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_synthetic_mnist_is_the_references():
    for seed in (0, 7):
        for a, b in zip(tit.make_synthetic_mnist(12, seed),
                        jit.make_synthetic_mnist(12, seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(train=True, seed=5), dict(train=False, seed=3, shuffle=False),
    dict(train=True, seed=1, binarize=True, flatten=True)])
def test_mnist_synthetic(kw, tmp_path, monkeypatch):
    monkeypatch.setattr(jit, "DATA_HOME", tmp_path)
    monkeypatch.setattr(tit, "DATA_HOME", tmp_path)
    got = tit.MnistDataSetIterator(16, num_examples=40, **kw)
    want = jit.MnistDataSetIterator(16, num_examples=40, **kw)
    assert len(got) == len(want) == 3 and got.total_outcomes() == 10
    _same(_batches(got), _batches(want))
    _same(_batches(got), _batches(want))          # after a reset


def _write_idx(path, arr, gz):
    dims = arr.shape
    head = bytes([0, 0, 8, len(dims)]) + b"".join(
        int(d).to_bytes(4, "big") for d in dims)
    data = head + arr.astype(np.uint8).tobytes()
    (gzip.open if gz else open)(path, "wb").write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_and_emnist_from_local_idx_files(gz, tmp_path, monkeypatch):
    monkeypatch.setattr(jit, "DATA_HOME", tmp_path)
    monkeypatch.setattr(tit, "DATA_HOME", tmp_path)
    rng = np.random.default_rng(0)
    sfx = ".gz" if gz else ""
    (tmp_path / "mnist").mkdir()
    _write_idx(tmp_path / "mnist" / f"train-images-idx3-ubyte{sfx}",
               rng.integers(0, 256, (30, 28, 28)), gz)
    _write_idx(tmp_path / "mnist" / f"train-labels-idx1-ubyte{sfx}",
               rng.integers(0, 10, 30), gz)
    _same(_batches(tit.MnistDataSetIterator(8, num_examples=30, seed=2)),
          _batches(jit.MnistDataSetIterator(8, num_examples=30, seed=2)))
    (tmp_path / "emnist").mkdir()
    _write_idx(tmp_path / "emnist" /
               f"emnist-letters-train-images-idx3-ubyte{sfx}",
               rng.integers(0, 256, (20, 28, 28)), gz)
    _write_idx(tmp_path / "emnist" /
               f"emnist-letters-train-labels-idx1-ubyte{sfx}",
               rng.integers(1, 27, 20), gz)
    got = tit.EmnistDataSetIterator(8, split="letters", num_examples=20)
    want = jit.EmnistDataSetIterator(8, split="letters", num_examples=20)
    assert got.total_outcomes() == want.total_outcomes() == 26
    _same(_batches(got), _batches(want))


@pytest.mark.parametrize("split", ["digits", "balanced", "letters"])
def test_emnist_synthetic(split, tmp_path, monkeypatch):
    monkeypatch.setattr(jit, "DATA_HOME", tmp_path)
    monkeypatch.setattr(tit, "DATA_HOME", tmp_path)
    _same(_batches(tit.EmnistDataSetIterator(10, split=split,
                                             num_examples=25, seed=4)),
          _batches(jit.EmnistDataSetIterator(10, split=split,
                                             num_examples=25, seed=4)))
    with pytest.raises(ValueError, match="unknown EMNIST split"):
        tit.EmnistDataSetIterator(10, split="nope")


def test_cifar10_synthetic_and_from_files(tmp_path, monkeypatch):
    monkeypatch.setattr(jit, "DATA_HOME", tmp_path)
    monkeypatch.setattr(tit, "DATA_HOME", tmp_path)
    for train in (True, False):
        _same(_batches(tit.Cifar10DataSetIterator(8, train=train, seed=3,
                                                  num_examples=20)),
              _batches(jit.Cifar10DataSetIterator(8, train=train, seed=3,
                                                  num_examples=20)))
    rng = np.random.default_rng(1)
    (tmp_path / "cifar10").mkdir()
    rows = np.concatenate([rng.integers(0, 10, (6, 1)),
                           rng.integers(0, 256, (6, 3072))], axis=1)
    (tmp_path / "cifar10" / "test_batch.bin").write_bytes(
        rows.astype(np.uint8).tobytes())
    _same(_batches(tit.Cifar10DataSetIterator(4, train=False)),
          _batches(jit.Cifar10DataSetIterator(4, train=False)))


def test_iris_array_iterator_random():
    _same(_batches(tit.IrisDataSetIterator(32)),
          _batches(jit.IrisDataSetIterator(32)))
    _same(_batches(tit.IrisDataSetIterator(50, num_examples=120)),
          _batches(jit.IrisDataSetIterator(50, num_examples=120)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = rng.standard_normal((10, 2)).astype(np.float32)
    _same(_batches(tit.ArrayDataSetIterator(x, y, 4)),
          _batches(jit.ArrayDataSetIterator(x, y, 4)))
    for fv, lv in (("random_uniform", "one_hot"), ("random_normal", "ones"),
                   ("zeros", "random_uniform")):
        kw = dict(feature_values=fv, label_values=lv, seed=9)
        _same(_batches(tit.RandomDataSetIterator(3, (4, 5), (4, 3), **kw)),
              _batches(jit.RandomDataSetIterator(3, (4, 5), (4, 3), **kw)))


def test_iterator_dataset_and_multiple_epochs():
    rng = np.random.default_rng(3)
    parts = [(rng.standard_normal((n, 3)).astype(np.float32),
              rng.standard_normal((n, 2)).astype(np.float32),
              (rng.random((n, 3)) > 0.5).astype(np.float32))
             for n in (5, 2, 6)]
    got = tit.IteratorDataSetIterator(
        (DataSet(x, y, m) for x, y, m in parts), 4)
    want = jit.IteratorDataSetIterator(
        (JDataSet(x, y, m) for x, y, m in parts), 4)
    _same(_batches(got), _batches(want))
    with pytest.raises(ValueError, match="no DataSets"):
        tit.IteratorDataSetIterator(iter([]), 4)
    x, y = parts[0][:2]
    got = tit.MultipleEpochsIterator(3, tit.ArrayDataSetIterator(x, y, 2))
    want = jit.MultipleEpochsIterator(3, jit.ArrayDataSetIterator(x, y, 2))
    assert got.total_examples() == want.total_examples() == 15
    _same(_batches(got), _batches(want))


def test_kfold_gives_the_references_folds():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((23, 3)).astype(np.float32)
    y = rng.standard_normal((23, 2)).astype(np.float32)
    got = list(tit.KFoldIterator(4, DataSet(x, y)))
    want = list(jit.KFoldIterator(4, JDataSet(x, y)))
    assert len(got) == len(want) == 4
    for (gtr, gte), (wtr, wte) in zip(got, want):
        _same(_batches([gtr, gte]), _batches([wtr, wte]))


def test_async_supported_and_protocol():
    it = tit.IrisDataSetIterator(50)
    assert it.async_supported() and it.batch() == 50
    assert it.total_outcomes() == 3 and it.input_columns() == -1
    ds = it.next()
    assert ds.num_examples() == 50 and it.has_next()
    it.reset()
    assert sum(d.num_examples() for d in it) == 150
