"""DataSet / MultiDataSet — port of ``deeplearning4j_tpu/data/dataset.py``
(feature + label containers).

Host data stays numpy (cheap slicing for an input pipeline) and moves to
the net's device in ``fit``; tensors (already on the card, say) are kept
as they are, so a staged batch never bounces through the host. The
``save``/``load`` npz format and ``merge`` take numpy data.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _as_host_or_device(a):
    """numpy for host data; tensors pass through untouched."""
    if a is None or isinstance(a, (np.ndarray, torch.Tensor)):
        return a
    return np.asarray(a)


class DataSet:
    def __init__(self, features, labels, features_mask=None, labels_mask=None):
        self.features = _as_host_or_device(features)
        self.labels = _as_host_or_device(labels)
        self.features_mask = _as_host_or_device(features_mask)
        self.labels_mask = _as_host_or_device(labels_mask)

    # reference getters
    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def __len__(self):
        return self.num_examples()

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return self._take(idx)

    def _take(self, idx) -> "DataSet":
        def take(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a[torch.as_tensor(idx, device=a.device)]
            return a[idx]
        return DataSet(take(self.features), take(self.labels),
                       take(self.features_mask), take(self.labels_mask))

    def split_test_and_train(self, n_train: int):
        """Reference splitTestAndTrain → (train, test)."""
        return self._take(np.arange(0, n_train)), \
            self._take(np.arange(n_train, self.num_examples()))

    def sample(self, n: int, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        return self._take(rng.choice(self.num_examples(), size=n, replace=False))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            out.append(self._take(np.arange(i, min(i + batch_size, self.num_examples()))))
        return out

    def merge(others: Sequence["DataSet"]) -> "DataSet":  # noqa: N805 — static-style
        ds = list(others)
        return DataSet(
            np.concatenate([d.features for d in ds]),
            np.concatenate([d.labels for d in ds]),
            None if ds[0].features_mask is None else np.concatenate([d.features_mask for d in ds]),
            None if ds[0].labels_mask is None else np.concatenate([d.labels_mask for d in ds]))

    def save(self, path):
        parts = {"features": self.features, "labels": self.labels}
        if self.features_mask is not None:
            parts["features_mask"] = self.features_mask
        if self.labels_mask is not None:
            parts["labels_mask"] = self.labels_mask
        np.savez_compressed(path, **parts)

    @staticmethod
    def load(path) -> "DataSet":
        with np.load(path) as z:
            return DataSet(z["features"], z["labels"],
                           z["features_mask"] if "features_mask" in z else None,
                           z["labels_mask"] if "labels_mask" in z else None)

    def __repr__(self):
        return (f"DataSet(features{tuple(self.features.shape)}, "
                f"labels{tuple(self.labels.shape)}, "
                f"fmask={None if self.features_mask is None else tuple(self.features_mask.shape)}, "
                f"lmask={None if self.labels_mask is None else tuple(self.labels_mask.shape)})")


class MultiDataSet:
    """N features arrays, M labels arrays (reference MultiDataSet)."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = [_as_host_or_device(f) for f in _as_list(features)]
        self.labels = [_as_host_or_device(l) for l in _as_list(labels)]
        self.features_masks = (None if features_masks is None
                               else [_as_host_or_device(m)
                                     for m in _as_list(features_masks)])
        self.labels_masks = (None if labels_masks is None
                             else [_as_host_or_device(m)
                                   for m in _as_list(labels_masks)])

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def __len__(self):
        return self.num_examples()


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
