"""deeplearning4j_tpu_torch.autodiff — the SameDiff graph API and the TF
GraphDef importer (port of ``deeplearning4j_tpu/autodiff``; the ONNX
importer is not ported yet)."""

from .samediff import History, SameDiff, SDVariable, TrainingConfig
from .tf_import import import_frozen_graph

__all__ = ["History", "SameDiff", "SDVariable", "TrainingConfig",
           "import_frozen_graph"]
