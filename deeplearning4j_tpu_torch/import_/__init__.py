"""deeplearning4j_tpu_torch.import_ — model import (deeplearning4j-modelimport;
port of ``deeplearning4j_tpu/import_``): Keras ``.h5`` and ``.keras``
files, read with the port's own HDF5 reader."""

from .keras import (KerasLambdaLayer, clear_custom_layers,
                    import_keras_model, import_keras_sequential,
                    register_custom_layer, register_lambda)

__all__ = ["KerasLambdaLayer", "clear_custom_layers", "import_keras_model",
           "import_keras_sequential", "register_custom_layer",
           "register_lambda"]
