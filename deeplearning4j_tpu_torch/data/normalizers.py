"""Data normalizers — port of ``deeplearning4j_tpu/data/normalizers.py``
(``org.nd4j.linalg.dataset.api.preprocessor``).

NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler,
VGG16ImagePreProcessor, MultiNormalizerStandardize/MinMaxScaler,
CompositeDataSetPreProcessor. fit(iterator) accumulates streaming stats;
transform/revert operate on DataSets or raw arrays; picklable for
ModelSerializer.addNormalizerToModel parity (``serde.model_serializer``
stores them in the port's own record). The statistics and transforms are
numpy on the host, as in the reference: a tensor handed in is read to the
host first.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataset import DataSet, MultiDataSet


def _host(a, dtype):
    """``a`` (host data or a tensor, read to the host) as numpy ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class _Stats:
    """Streaming mean/std/min/max accumulator over the batch axis."""

    def __init__(self):
        self.n = 0
        self.sum = None
        self.sum_sq = None
        self.min = None
        self.max = None

    def update(self, x: np.ndarray):
        x = _host(x, np.float64)
        flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(-1, 1)
        s = flat.sum(0)
        ss = (flat * flat).sum(0)
        mn = flat.min(0)
        mx = flat.max(0)
        if self.sum is None:
            self.sum, self.sum_sq, self.min, self.max = s, ss, mn, mx
        else:
            self.sum += s
            self.sum_sq += ss
            self.min = np.minimum(self.min, mn)
            self.max = np.maximum(self.max, mx)
        self.n += flat.shape[0]

    @property
    def mean(self):
        return self.sum / self.n

    @property
    def std(self):
        var = self.sum_sq / self.n - self.mean ** 2
        return np.sqrt(np.maximum(var, 1e-12))


class AbstractNormalizer:
    fit_labels = False

    def fit_label(self, flag: bool):
        self.fit_labels = flag
        return self

    def fit(self, data):
        """fit(DataSetIterator | DataSet)."""
        it = [data] if isinstance(data, DataSet) else data
        for ds in it:
            self._update(ds)
        if hasattr(data, "reset"):
            data.reset()
        return self

    def transform(self, ds: DataSet) -> DataSet:
        out = DataSet(self._tf(_host(ds.features, np.float32)),
                      ds.labels if not self.fit_labels
                      else self._tf_labels(_host(ds.labels, np.float32)),
                      ds.features_mask, ds.labels_mask)
        return out

    def pre_process(self, ds: DataSet) -> DataSet:  # reference naming
        return self.transform(ds)

    def __call__(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    def revert(self, ds: DataSet) -> DataSet:
        return DataSet(self._inv(_host(ds.features, np.float32)),
                       ds.labels if not self.fit_labels
                       else self._inv_labels(_host(ds.labels, np.float32)),
                       ds.features_mask, ds.labels_mask)

    def revert_features(self, f):
        return self._inv(_host(f, np.float32))

    def revert_labels(self, l):
        if not self.fit_labels:
            return l
        return self._inv_labels(_host(l, np.float32))


class NormalizerStandardize(AbstractNormalizer):
    """Zero-mean unit-variance per feature column."""

    def __init__(self):
        self._f = _Stats()
        self._l = _Stats()

    def _update(self, ds):
        self._f.update(ds.features)
        if self.fit_labels:
            self._l.update(ds.labels)

    def _tf(self, x):
        return ((x - self._f.mean) / self._f.std).astype(np.float32)

    def _inv(self, x):
        return (x * self._f.std + self._f.mean).astype(np.float32)

    def _tf_labels(self, y):
        return ((y - self._l.mean) / self._l.std).astype(np.float32)

    def _inv_labels(self, y):
        return (y * self._l.std + self._l.mean).astype(np.float32)

    @property
    def mean(self):
        return self._f.mean

    @property
    def std(self):
        return self._f.std


class NormalizerMinMaxScaler(AbstractNormalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self._f = _Stats()
        self._l = _Stats()

    def _update(self, ds):
        self._f.update(ds.features)
        if self.fit_labels:
            self._l.update(ds.labels)

    def _scale(self, x, st):
        return _minmax_scale(x, st, self.min_range, self.max_range)

    def _unscale(self, x, st):
        rng = np.maximum(st.max - st.min, 1e-12)
        unit = (x - self.min_range) / (self.max_range - self.min_range)
        return (unit * rng + st.min).astype(np.float32)

    def _tf(self, x):
        return self._scale(x, self._f)

    def _inv(self, x):
        return self._unscale(x, self._f)

    def _tf_labels(self, y):
        return self._scale(y, self._l)

    def _inv_labels(self, y):
        return self._unscale(y, self._l)


class ImagePreProcessingScaler(AbstractNormalizer):
    """Scale pixel range [0,maxPixel] → [a,b] (no fit needed)."""

    def __init__(self, a: float = 0.0, b: float = 1.0, max_pixel_value: float = 255.0):
        self.a, self.b, self.max_pixel = a, b, max_pixel_value

    def fit(self, data):
        return self

    def _update(self, ds):
        pass

    def _tf(self, x):
        return (x / self.max_pixel * (self.b - self.a) + self.a).astype(np.float32)

    def _inv(self, x):
        return ((x - self.a) / (self.b - self.a) * self.max_pixel).astype(np.float32)


class VGG16ImagePreProcessor(AbstractNormalizer):
    """Subtract ImageNet channel means (RGB), NHWC."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def fit(self, data):
        return self

    def _update(self, ds):
        pass

    def _tf(self, x):
        return (x - self.MEANS).astype(np.float32)

    def _inv(self, x):
        return (x + self.MEANS).astype(np.float32)


class _MultiNormalizerBase:
    """Shared streaming fit over MultiDataSet inputs/outputs; subclasses
    define the per-array transform via _apply(x, stats)."""

    def __init__(self):
        self._f: list = []
        self._l: list = []
        self.fit_labels = False

    def fit_label(self, flag: bool):
        self.fit_labels = flag
        return self

    def fit(self, data):
        it = [data] if isinstance(data, MultiDataSet) else data
        for mds in it:
            if not self._f:
                self._f = [_Stats() for _ in mds.features]
                self._l = [_Stats() for _ in mds.labels]
            for st, f in zip(self._f, mds.features):
                st.update(f)
            if self.fit_labels:
                for st, l in zip(self._l, mds.labels):
                    st.update(l)
        if hasattr(data, "reset"):
            data.reset()
        return self

    def _apply(self, x, st):  # pragma: no cover — abstract
        raise NotImplementedError

    def transform(self, mds: MultiDataSet) -> MultiDataSet:
        feats = [self._apply(f, st) for st, f in zip(self._f, mds.features)]
        labs = mds.labels if not self.fit_labels else [
            self._apply(l, st) for st, l in zip(self._l, mds.labels)]
        return MultiDataSet(feats, labs, mds.features_masks, mds.labels_masks)


class MultiNormalizerStandardize(_MultiNormalizerBase):
    """Per-input/per-output standardization for MultiDataSet."""

    def _apply(self, x, st):
        return ((_host(x, np.float32) - st.mean) / st.std
                ).astype(np.float32)


def _minmax_scale(x, st, lo, hi):
    rng = np.maximum(st.max - st.min, 1e-12)
    unit = (_host(x, np.float32) - st.min) / rng
    return (unit * (hi - lo) + lo).astype(np.float32)


class MultiNormalizerMinMaxScaler(_MultiNormalizerBase):
    """Per-input/per-output min-max scaling for MultiDataSet (reference
    MultiNormalizerMinMaxScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        super().__init__()
        self.min_range = min_range
        self.max_range = max_range

    def _apply(self, x, st):
        return _minmax_scale(x, st, self.min_range, self.max_range)


class CompositeDataSetPreProcessor:
    def __init__(self, *preprocessors):
        self.preprocessors = preprocessors

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def pre_process(self, ds):
        return self.transform(ds)
