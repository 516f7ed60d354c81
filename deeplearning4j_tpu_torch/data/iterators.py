"""DataSetIterators — port of ``deeplearning4j_tpu/data/iterators.py``
(the ``DataSetIterator`` protocol, hasNext/next/reset/batch/totalOutcomes,
and the builtin iterators ``ListDataSetIterator``, ``ArrayDataSetIterator``,
``IteratorDataSetIterator``, ``RandomDataSetIterator``,
``MnistDataSetIterator``, ``EmnistDataSetIterator``,
``IrisDataSetIterator``, ``Cifar10DataSetIterator``, ``KFoldIterator``,
``MultipleEpochsIterator``).

Batches are host numpy, as the reference's are; ``fit`` moves them to the
net's device (through the async prefetch of ``data/async_iter.py`` for
every iterator whose ``async_supported()`` is True). A
``ListDataSetIterator`` over tensors already on the card slices them
there, and has nothing to prefetch: its ``async_supported()`` is False,
so ``fit`` iterates it directly and its batches never cross the host.

Nothing is downloaded. MNIST, EMNIST and CIFAR-10 are read from the
reference's files under ``DATA_HOME`` (``$DL4J_TPU_DATA``, else
``~/.deeplearning4j_tpu``: ``mnist/``, ``emnist/``, ``cifar10/``) when
they are there; otherwise they are the reference's procedural datasets,
copied here, so the same seed gives the same arrays as the reference.
"""

from __future__ import annotations

import gzip
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .async_iter import on_device
from .dataset import DataSet

DATA_HOME = Path(os.environ.get("DL4J_TPU_DATA",
                                Path.home() / ".deeplearning4j_tpu"))


class BaseDatasetIterator:
    """Python-iterable + reference-style hasNext/next protocol."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._cursor = 0

    # --- python protocol ---------------------------------------------------
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def __len__(self):
        return math.ceil(self.total_examples() / self.batch_size)

    # --- reference protocol ------------------------------------------------
    def has_next(self) -> bool:
        return self._cursor < self.total_examples()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        ds = self._slice(self._cursor,
                         min(self._cursor + n, self.total_examples()))
        self._cursor += n
        return ds

    def reset(self):
        self._cursor = 0

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        raise NotImplementedError

    def _slice(self, lo, hi) -> DataSet:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1

    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(BaseDatasetIterator):
    """Iterates a list of pre-built DataSets (reference ListDataSetIterator)."""

    def __init__(self, data, batch_size: Optional[int] = None):
        if isinstance(data, DataSet):
            data = [data]
        self._datasets = list(data)
        self._full = (DataSet.merge(self._datasets) if len(self._datasets) > 1
                      else self._datasets[0])
        super().__init__(batch_size or self._full.num_examples())

    def total_examples(self):
        return self._full.num_examples()

    def _slice(self, lo, hi):
        return self._full._take(np.arange(lo, hi))

    def total_outcomes(self):
        return int(self._full.labels.shape[-1])

    def async_supported(self) -> bool:
        """False when the data lives on the card (nothing to prefetch,
        and the producer thread must never touch the card)."""
        return not on_device(self._full)


class ArrayDataSetIterator(ListDataSetIterator):
    def __init__(self, features, labels, batch_size):
        super().__init__(DataSet(features, labels), batch_size)


class IteratorDataSetIterator(ListDataSetIterator):
    """Wrap a plain iterable of DataSets (any sizes) into the
    DataSetIterator protocol, RE-BATCHED to a fixed batch size (reference
    IteratorDataSetIterator). The source is read ONCE up front and merged
    (masks included) — exactly ListDataSetIterator's machinery; reset()
    rewinds the cursor over the cached arrays. A trailing partial batch is
    delivered, not dropped."""

    def __init__(self, source, batch_size: int):
        chunks = list(source)
        if not chunks:
            raise ValueError("source iterable produced no DataSets")
        super().__init__(chunks, batch_size)


class RandomDataSetIterator(BaseDatasetIterator):
    """Random features/labels with the given shapes (testing/benching)."""

    VALUES = ("zeros", "ones", "random_uniform", "random_normal", "one_hot")

    def __init__(self, n_batches, features_shape, labels_shape, batch_size=None,
                 feature_values="random_uniform", label_values="one_hot", seed=0):
        bs = features_shape[0] if batch_size is None else batch_size
        super().__init__(bs)
        self.n_batches = n_batches
        self.features_shape = tuple(features_shape)
        self.labels_shape = tuple(labels_shape)
        self.feature_values = feature_values
        self.label_values = label_values
        self.seed = seed

    def total_examples(self):
        return self.n_batches * self.batch_size

    def _gen(self, shape, kind, rng):
        if kind == "zeros":
            return np.zeros(shape, np.float32)
        if kind == "ones":
            return np.ones(shape, np.float32)
        if kind == "random_normal":
            return rng.standard_normal(shape).astype(np.float32)
        if kind == "one_hot":
            cls = rng.integers(0, shape[-1], size=shape[:-1])
            out = np.zeros(shape, np.float32)
            np.put_along_axis(out, cls[..., None], 1.0, axis=-1)
            return out
        return rng.random(shape).astype(np.float32)

    def _slice(self, lo, hi):
        rng = np.random.default_rng(self.seed + lo)
        n = hi - lo
        f = self._gen((n,) + self.features_shape[1:] if len(self.features_shape) > 1
                      else (n,), self.feature_values, rng)
        l = self._gen((n,) + self.labels_shape[1:] if len(self.labels_shape) > 1
                      else (n,), self.label_values, rng)
        return DataSet(f, l)


# --------------------------------------------------------------------------
# Procedural digit rendering (offline MNIST substitute)
# --------------------------------------------------------------------------
_SEG = {  # 7-segment-ish strokes per digit on a 20x20 canvas: (r0,c0,r1,c1)
    0: [(2, 5, 2, 14), (17, 5, 17, 14), (2, 5, 17, 5), (2, 14, 17, 14)],
    1: [(2, 10, 17, 10), (2, 10, 5, 7)],
    2: [(2, 5, 2, 14), (2, 14, 9, 14), (9, 5, 9, 14), (9, 5, 17, 5), (17, 5, 17, 14)],
    3: [(2, 5, 2, 14), (9, 7, 9, 14), (17, 5, 17, 14), (2, 14, 17, 14)],
    4: [(2, 5, 9, 5), (9, 5, 9, 14), (2, 14, 17, 14)],
    5: [(2, 5, 2, 14), (2, 5, 9, 5), (9, 5, 9, 14), (9, 14, 17, 14), (17, 5, 17, 14)],
    6: [(2, 5, 2, 14), (2, 5, 17, 5), (9, 5, 9, 14), (9, 14, 17, 14), (17, 5, 17, 14)],
    7: [(2, 5, 2, 14), (2, 14, 17, 8)],
    8: [(2, 5, 2, 14), (9, 5, 9, 14), (17, 5, 17, 14), (2, 5, 17, 5), (2, 14, 17, 14)],
    9: [(2, 5, 2, 14), (2, 5, 9, 5), (9, 5, 9, 14), (2, 14, 17, 14), (17, 5, 17, 14)],
}


def _render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((20, 20), np.float32)
    for (r0, c0, r1, c1) in _SEG[digit]:
        n = max(abs(r1 - r0), abs(c1 - c0)) + 1
        rr = np.linspace(r0, r1, n * 2).round().astype(int)
        cc = np.linspace(c0, c1, n * 2).round().astype(int)
        img[np.clip(rr, 0, 19), np.clip(cc, 0, 19)] = 1.0
        img[np.clip(rr + 1, 0, 19), np.clip(cc, 0, 19)] = 1.0  # stroke width 2
    # random affine: shift + slight rotation/scale via coordinate remap
    angle = rng.uniform(-0.25, 0.25)
    scale = rng.uniform(0.85, 1.15)
    ca, sa = math.cos(angle) * scale, math.sin(angle) * scale
    ys, xs = np.mgrid[0:28, 0:28].astype(np.float32)
    cy = 13.5 + rng.uniform(-2, 2)
    cx = 13.5 + rng.uniform(-2, 2)
    src_y = ((ys - cy) * ca - (xs - cx) * sa) + 9.5
    src_x = ((ys - cy) * sa + (xs - cx) * ca) + 9.5
    yi = np.clip(src_y.round().astype(int), 0, 19)
    xi = np.clip(src_x.round().astype(int), 0, 19)
    valid = (src_y >= 0) & (src_y < 20) & (src_x >= 0) & (src_x < 20)
    out = np.where(valid, img[yi, xi], 0.0).astype(np.float32)
    out += rng.normal(0, 0.08, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def make_synthetic_mnist(n: int, seed: int = 0):
    """(n,28,28,1) images + (n,10) one-hot labels, deterministic per seed."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(0, 10, size=n)
    imgs = np.stack([_render_digit(int(d), rng) for d in digits])[..., None]
    labels = np.zeros((n, 10), np.float32)
    labels[np.arange(n), digits] = 1.0
    return imgs, labels


def _load_idx(path: Path) -> Optional[np.ndarray]:
    try:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        magic = int.from_bytes(data[:4], "big")
        ndim = magic & 0xFF
        dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
        arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)
        return arr
    except Exception:  # noqa: BLE001
        return None


def _load_idx_image_dataset(image_stem: Path, label_stem: Path, n: int,
                            n_classes: int, label_offset: int = 0):
    """Shared MNIST/EMNIST idx loading: (N,28,28,1) float [0,1] + one-hot.
    Tries bare and .gz filenames; returns (None, None) when absent."""
    for suffix in ("", ".gz"):
        fi = Path(str(image_stem) + suffix)
        fl = Path(str(label_stem) + suffix)
        if fi.exists() and fl.exists():
            imgs = _load_idx(fi)
            labels = _load_idx(fl)
            if imgs is not None and labels is not None:
                imgs = (imgs[:n].astype(np.float32) / 255.0)[..., None]
                labels = labels[:n].astype(int) - label_offset
                onehot = np.zeros((len(labels), n_classes), np.float32)
                onehot[np.arange(len(labels)), labels] = 1.0
                return imgs, onehot
    return None, None


class MnistDataSetIterator(BaseDatasetIterator):
    """Reference MnistDataSetIterator: (B,28,28,1) NHWC in [0,1], 10-class
    one-hot. Real IDX files used when present; else procedural digits."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None, binarize: bool = False,
                 shuffle: bool = True, flatten: bool = False):
        super().__init__(batch_size)
        self.flatten = flatten
        n_default = 60000 if train else 10000
        n = num_examples or n_default
        imgs, labels = self._load_real(train, n)
        if imgs is None:
            imgs, labels = self._synthetic(n, seed + (0 if train else 10**6))
        if binarize:
            imgs = (imgs > 0.5).astype(np.float32)
        if shuffle:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(imgs))
            imgs, labels = imgs[idx], labels[idx]
        if flatten:
            imgs = imgs.reshape(len(imgs), -1)
        self._features, self._labels = imgs, labels

    def _synthetic(self, n, seed):
        return make_synthetic_mnist(n, seed=seed)

    def _load_real(self, train: bool, n: int):
        base = DATA_HOME / "mnist"
        stem = "train" if train else "t10k"
        return _load_idx_image_dataset(base / f"{stem}-images-idx3-ubyte",
                                       base / f"{stem}-labels-idx1-ubyte",
                                       n, 10)

    def total_examples(self):
        return len(self._features)

    def _slice(self, lo, hi):
        return DataSet(self._features[lo:hi], self._labels[lo:hi])

    def total_outcomes(self):
        return 10


class EmnistDataSetIterator(MnistDataSetIterator):
    """Reference EmnistDataSetIterator with its Set splits. Real idx files
    (``~/.deeplearning4j_tpu/emnist/emnist-<split>-<train|test>-images-idx3-
    ubyte[.gz]``, the NIST naming) when present; else procedural glyphs
    (digit shape + deterministic per-class roll so classes >= 10 stay
    separable)."""

    NUM_CLASSES = {"complete": 62, "byclass": 62, "bymerge": 47,
                   "balanced": 47, "letters": 26, "digits": 10, "mnist": 10}

    def __init__(self, batch_size: int, split: str = "digits",
                 train: bool = True, **kw):
        if split not in self.NUM_CLASSES:
            raise ValueError(f"unknown EMNIST split {split!r}; "
                             f"one of {sorted(self.NUM_CLASSES)}")
        self.split = split
        self.n_classes = self.NUM_CLASSES[split]
        super().__init__(batch_size, train=train, **kw)

    def _load_real(self, train, n):
        base = DATA_HOME / "emnist"
        stem = "train" if train else "test"
        return _load_idx_image_dataset(
            base / f"emnist-{self.split}-{stem}-images-idx3-ubyte",
            base / f"emnist-{self.split}-{stem}-labels-idx1-ubyte",
            n, self.n_classes,
            # the NIST letters files are 1-indexed (a=1) — keyed on the
            # split, not on the observed label range (deterministic)
            label_offset=1 if self.split == "letters" else 0)

    def _synthetic(self, n, seed):
        rng = np.random.default_rng(seed)
        cls = rng.integers(0, self.n_classes, size=n)
        imgs = np.stack([np.roll(_render_digit(int(c) % 10, rng),
                                 3 * (int(c) // 10), axis=0)
                         for c in cls])[..., None]
        labels = np.zeros((n, self.n_classes), np.float32)
        labels[np.arange(n), cls] = 1.0
        return imgs, labels

    def total_outcomes(self):
        return self.n_classes


class IrisDataSetIterator(BaseDatasetIterator):
    """The classic 150-flower dataset, embedded (reference IrisDataSetIterator)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150):
        super().__init__(batch_size)
        f, l = _iris_data()
        self._features, self._labels = f[:num_examples], l[:num_examples]

    def total_examples(self):
        return len(self._features)

    def _slice(self, lo, hi):
        return DataSet(self._features[lo:hi], self._labels[lo:hi])

    def total_outcomes(self):
        return 3


class Cifar10DataSetIterator(BaseDatasetIterator):
    """(B,32,32,3) NHWC. Real CIFAR-10 binary batches when on disk under
    ``~/.deeplearning4j_tpu/cifar10/``; else a procedural 10-class color-
    texture dataset with the same shape contract."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 7,
                 num_examples: Optional[int] = None):
        super().__init__(batch_size)
        n = num_examples or (50000 if train else 10000)
        data = self._load_real(train, n)
        if data is None:
            rng = np.random.default_rng(seed + (0 if train else 999))
            cls = rng.integers(0, 10, n)
            freqs = (cls + 1)[:, None, None, None] * 0.35
            ys, xs = np.mgrid[0:32, 0:32] / 32.0
            base = np.sin(freqs * ys[None, ..., None] * 2 * np.pi +
                          (cls % 3)[:, None, None, None]) \
                * np.cos(freqs * xs[None, ..., None] * 2 * np.pi)
            imgs = (0.5 + 0.5 * base + rng.normal(0, 0.1, (n, 32, 32, 3))).astype(np.float32)
            imgs = np.clip(imgs, 0, 1)
            labels = np.zeros((n, 10), np.float32)
            labels[np.arange(n), cls] = 1.0
            data = (imgs, labels)
        self._features, self._labels = data

    @staticmethod
    def _load_real(train, n):
        base = DATA_HOME / "cifar10"
        files = [base / f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else [base / "test_batch.bin"]
        if not all(f.exists() for f in files):
            return None
        rows = []
        for f in files:
            raw = np.frombuffer(f.read_bytes(), np.uint8).reshape(-1, 3073)
            rows.append(raw)
        raw = np.concatenate(rows)[:n]
        labels = np.zeros((len(raw), 10), np.float32)
        labels[np.arange(len(raw)), raw[:, 0]] = 1.0
        imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        return imgs, labels

    def total_examples(self):
        return len(self._features)

    def _slice(self, lo, hi):
        return DataSet(self._features[lo:hi], self._labels[lo:hi])

    def total_outcomes(self):
        return 10


class KFoldIterator:
    """K-fold splits of a DataSet (reference KFoldIterator)."""

    def __init__(self, k: int, dataset: DataSet):
        self.k = k
        self.dataset = dataset
        self._fold = 0
        n = dataset.num_examples()
        self._bounds = np.linspace(0, n, k + 1).astype(int)

    def __iter__(self):
        self._fold = 0
        return self

    def __next__(self):
        if self._fold >= self.k:
            raise StopIteration
        lo, hi = self._bounds[self._fold], self._bounds[self._fold + 1]
        idx = np.arange(self.dataset.num_examples())
        test = self.dataset._take(idx[lo:hi])
        train = self.dataset._take(np.concatenate([idx[:lo], idx[hi:]]))
        self._fold += 1
        return train, test


class MultipleEpochsIterator(BaseDatasetIterator):
    """Wraps an iterator to run N epochs as one pass (reference parity)."""

    def __init__(self, epochs: int, inner):
        super().__init__(inner.batch_size)
        self.epochs = epochs
        self.inner = inner

    def total_examples(self):
        return self.inner.total_examples() * self.epochs

    def reset(self):
        super().reset()
        self.inner.reset()

    def async_supported(self) -> bool:
        return getattr(self.inner, "async_supported", lambda: True)()

    def has_next(self):
        return self._cursor < self.total_examples()

    def next(self, num=None):
        if not self.inner.has_next():
            self.inner.reset()
        ds = self.inner.next(num)
        self._cursor += ds.num_examples()
        return ds


def _iris_data():
    """The 150-sample Fisher iris dataset (public domain values)."""
    raw = np.array(_IRIS_RAW, np.float32).reshape(150, 5)
    feats = raw[:, :4]
    labels = np.zeros((150, 3), np.float32)
    labels[np.arange(150), raw[:, 4].astype(int)] = 1.0
    return feats, labels


_IRIS_RAW = [
    5.1,3.5,1.4,0.2,0, 4.9,3.0,1.4,0.2,0, 4.7,3.2,1.3,0.2,0, 4.6,3.1,1.5,0.2,0,
    5.0,3.6,1.4,0.2,0, 5.4,3.9,1.7,0.4,0, 4.6,3.4,1.4,0.3,0, 5.0,3.4,1.5,0.2,0,
    4.4,2.9,1.4,0.2,0, 4.9,3.1,1.5,0.1,0, 5.4,3.7,1.5,0.2,0, 4.8,3.4,1.6,0.2,0,
    4.8,3.0,1.4,0.1,0, 4.3,3.0,1.1,0.1,0, 5.8,4.0,1.2,0.2,0, 5.7,4.4,1.5,0.4,0,
    5.4,3.9,1.3,0.4,0, 5.1,3.5,1.4,0.3,0, 5.7,3.8,1.7,0.3,0, 5.1,3.8,1.5,0.3,0,
    5.4,3.4,1.7,0.2,0, 5.1,3.7,1.5,0.4,0, 4.6,3.6,1.0,0.2,0, 5.1,3.3,1.7,0.5,0,
    4.8,3.4,1.9,0.2,0, 5.0,3.0,1.6,0.2,0, 5.0,3.4,1.6,0.4,0, 5.2,3.5,1.5,0.2,0,
    5.2,3.4,1.4,0.2,0, 4.7,3.2,1.6,0.2,0, 4.8,3.1,1.6,0.2,0, 5.4,3.4,1.5,0.4,0,
    5.2,4.1,1.5,0.1,0, 5.5,4.2,1.4,0.2,0, 4.9,3.1,1.5,0.2,0, 5.0,3.2,1.2,0.2,0,
    5.5,3.5,1.3,0.2,0, 4.9,3.6,1.4,0.1,0, 4.4,3.0,1.3,0.2,0, 5.1,3.4,1.5,0.2,0,
    5.0,3.5,1.3,0.3,0, 4.5,2.3,1.3,0.3,0, 4.4,3.2,1.3,0.2,0, 5.0,3.5,1.6,0.6,0,
    5.1,3.8,1.9,0.4,0, 4.8,3.0,1.4,0.3,0, 5.1,3.8,1.6,0.2,0, 4.6,3.2,1.4,0.2,0,
    5.3,3.7,1.5,0.2,0, 5.0,3.3,1.4,0.2,0, 7.0,3.2,4.7,1.4,1, 6.4,3.2,4.5,1.5,1,
    6.9,3.1,4.9,1.5,1, 5.5,2.3,4.0,1.3,1, 6.5,2.8,4.6,1.5,1, 5.7,2.8,4.5,1.3,1,
    6.3,3.3,4.7,1.6,1, 4.9,2.4,3.3,1.0,1, 6.6,2.9,4.6,1.3,1, 5.2,2.7,3.9,1.4,1,
    5.0,2.0,3.5,1.0,1, 5.9,3.0,4.2,1.5,1, 6.0,2.2,4.0,1.0,1, 6.1,2.9,4.7,1.4,1,
    5.6,2.9,3.6,1.3,1, 6.7,3.1,4.4,1.4,1, 5.6,3.0,4.5,1.5,1, 5.8,2.7,4.1,1.0,1,
    6.2,2.2,4.5,1.5,1, 5.6,2.5,3.9,1.1,1, 5.9,3.2,4.8,1.8,1, 6.1,2.8,4.0,1.3,1,
    6.3,2.5,4.9,1.5,1, 6.1,2.8,4.7,1.2,1, 6.4,2.9,4.3,1.3,1, 6.6,3.0,4.4,1.4,1,
    6.8,2.8,4.8,1.4,1, 6.7,3.0,5.0,1.7,1, 6.0,2.9,4.5,1.5,1, 5.7,2.6,3.5,1.0,1,
    5.5,2.4,3.8,1.1,1, 5.5,2.4,3.7,1.0,1, 5.8,2.7,3.9,1.2,1, 6.0,2.7,5.1,1.6,1,
    5.4,3.0,4.5,1.5,1, 6.0,3.4,4.5,1.6,1, 6.7,3.1,4.7,1.5,1, 6.3,2.3,4.4,1.3,1,
    5.6,3.0,4.1,1.3,1, 5.5,2.5,4.0,1.3,1, 5.5,2.6,4.4,1.2,1, 6.1,3.0,4.6,1.4,1,
    5.8,2.6,4.0,1.2,1, 5.0,2.3,3.3,1.0,1, 5.6,2.7,4.2,1.3,1, 5.7,3.0,4.2,1.2,1,
    5.7,2.9,4.2,1.3,1, 6.2,2.9,4.3,1.3,1, 5.1,2.5,3.0,1.1,1, 5.7,2.8,4.1,1.3,1,
    6.3,3.3,6.0,2.5,2, 5.8,2.7,5.1,1.9,2, 7.1,3.0,5.9,2.1,2, 6.3,2.9,5.6,1.8,2,
    6.5,3.0,5.8,2.2,2, 7.6,3.0,6.6,2.1,2, 4.9,2.5,4.5,1.7,2, 7.3,2.9,6.3,1.8,2,
    6.7,2.5,5.8,1.8,2, 7.2,3.6,6.1,2.5,2, 6.5,3.2,5.1,2.0,2, 6.4,2.7,5.3,1.9,2,
    6.8,3.0,5.5,2.1,2, 5.7,2.5,5.0,2.0,2, 5.8,2.8,5.1,2.4,2, 6.4,3.2,5.3,2.3,2,
    6.5,3.0,5.5,1.8,2, 7.7,3.8,6.7,2.2,2, 7.7,2.6,6.9,2.3,2, 6.0,2.2,5.0,1.5,2,
    6.9,3.2,5.7,2.3,2, 5.6,2.8,4.9,2.0,2, 7.7,2.8,6.7,2.0,2, 6.3,2.7,4.9,1.8,2,
    6.7,3.3,5.7,2.1,2, 7.2,3.2,6.0,1.8,2, 6.2,2.8,4.8,1.8,2, 6.1,3.0,4.9,1.8,2,
    6.4,2.8,5.6,2.1,2, 7.2,3.0,5.8,1.6,2, 7.4,2.8,6.1,1.9,2, 7.9,3.8,6.4,2.0,2,
    6.4,2.8,5.6,2.2,2, 6.3,2.8,5.1,1.5,2, 6.1,2.6,5.6,1.4,2, 7.7,3.0,6.1,2.3,2,
    6.3,3.4,5.6,2.4,2, 6.4,3.1,5.5,1.8,2, 6.0,3.0,4.8,1.8,2, 6.9,3.1,5.4,2.1,2,
    6.7,3.1,5.6,2.4,2, 6.9,3.1,5.1,2.3,2, 5.8,2.7,5.1,1.9,2, 6.8,3.2,5.9,2.3,2,
    6.7,3.3,5.7,2.5,2, 6.7,3.0,5.2,2.3,2, 6.3,2.5,5.0,1.9,2, 6.5,3.0,5.2,2.0,2,
    6.2,3.4,5.4,2.3,2, 5.9,3.0,5.1,1.8,2,
]
