"""ZooModel API — port of ``deeplearning4j_tpu/zoo/base.py``
(``org.deeplearning4j.zoo.ZooModel``): ``conf()`` gives the network
configuration, ``init(device=None)`` the initialized network (on the
CUDA card unless the caller asks for the CPU), and
``init_pretrained(path)`` a network with the weights of a local
checkpoint: a zip the port's model serializer wrote, or one the JAX
package's wrote (its params and states copied into this model's
network), or a Keras ``.h5``/``.hdf5`` file, routed through the Keras
importer by its ``model_config`` class. Nothing is downloaded.
"""

from __future__ import annotations

import zipfile
from dataclasses import dataclass
from typing import Any, Tuple


@dataclass
class ZooModel:
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple = ()          # (H, W, C) NHWC or model-specific
    updater: Any = None
    compute_dtype: Any = None        # e.g. torch.bfloat16

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        raise NotImplementedError

    def init_pretrained(self, path, device=None):
        """The network with the weights of the checkpoint at ``path``: a
        Keras ``.h5``/``.hdf5`` file is imported (a ``Sequential`` as a
        MultiLayerNetwork, anything else as a ComputationGraph); the
        port's zip loads whole (``serde.load_model``); a JAX package's zip
        loads into ``self.init(device)`` (``serde.load_params``, the
        equivalent configuration being this model's)."""
        from ..serde.model_serializer import RECORD, load_model, load_params
        if str(path).endswith((".h5", ".hdf5")):
            import json

            from ..import_ import _hdf5
            from ..import_.keras import (import_keras_model,
                                         import_keras_sequential)
            with _hdf5.File(path) as f:   # route EXPLICITLY by class
                raw = f.attrs["model_config"]
                cls = json.loads(
                    raw.decode() if isinstance(raw, bytes) else raw
                )["class_name"]
            if cls == "Sequential":
                return import_keras_sequential(path, device=device)
            return import_keras_model(path, device=device)
        with zipfile.ZipFile(path) as zf:
            ours = RECORD in zf.namelist()
        if ours:
            return load_model(path, device=device)
        net = self.init(device=device)
        load_params(net, path)
        return net

    def meta_data(self, device=None) -> dict:
        net = self.init(device=device)
        return {"name": type(self).__name__, "num_params": net.num_params(),
                "input_shape": self.input_shape, "num_classes": self.num_classes}
