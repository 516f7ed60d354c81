"""Zip checkpoints of the port (``deeplearning4j_tpu.serde`` analogue):
``save_model`` / ``load_model`` for the port's own zips, ``load_params``
for a zip of either package into an existing net, ``restore_normalizer``."""

from .model_serializer import (load_model, load_params, restore_normalizer,
                               save_model)

__all__ = ["load_model", "load_params", "restore_normalizer", "save_model"]
