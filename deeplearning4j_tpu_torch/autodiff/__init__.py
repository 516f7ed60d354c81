"""deeplearning4j_tpu_torch.autodiff — the SameDiff graph API, the TF
GraphDef importer and the ONNX importer (port of
``deeplearning4j_tpu/autodiff``)."""

from .onnx_import import import_onnx, parse_onnx
from .samediff import History, SameDiff, SDVariable, TrainingConfig
from .tf_import import import_frozen_graph

__all__ = ["History", "SameDiff", "SDVariable", "TrainingConfig",
           "import_frozen_graph", "import_onnx", "parse_onnx"]
