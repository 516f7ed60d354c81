"""ZooModel API — port of ``deeplearning4j_tpu/zoo/base.py``
(``org.deeplearning4j.zoo.ZooModel``): ``conf()`` gives the network
configuration and ``init(device=None)`` the initialized network, on the
CUDA card unless the caller asks for the CPU. Pretrained loading (the
model serializer and the Keras importer) is not ported yet.
"""

from __future__ import annotations

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

    def init_pretrained(self, path):
        raise NotImplementedError(
            "ZooModel.init_pretrained (the model serializer and the Keras "
            "importer) is not ported yet")

    def meta_data(self, device=None) -> dict:
        net = self.init(device=device)
        return {"name": type(self).__name__, "num_params": net.num_params(),
                "input_shape": self.input_shape, "num_classes": self.num_classes}
