"""Zip checkpoints of the port (``deeplearning4j_tpu.serde`` analogue):
``save_model`` / ``load_model`` for the port's own zips (``load_model``
also restores upstream DL4J zips and SameDiff zips), ``load_params`` for
a zip of either package into an existing net, ``restore_normalizer``,
and the upstream DL4J format both ways (``upstream_dl4j``).
``ModelSerializer`` is the DL4J-shaped static facade over them.
``OrbaxCheckpointer`` / ``PreemptionWatchdog`` (``orbax_ckpt``) are the
async per-rank checkpoints on ``torch.distributed.checkpoint``."""

from .model_serializer import (load_model, load_params, restore_normalizer,
                               save_model)
from .orbax_ckpt import OrbaxCheckpointer, PreemptionWatchdog
from .upstream_dl4j import (is_upstream_format,
                            restore_upstream_computation_graph,
                            restore_upstream_multi_layer_network,
                            write_computation_graph_upstream_format,
                            write_model_upstream_format)


class ModelSerializer:
    """DL4J-style static facade (``writeModel`` / ``restoreMultiLayerNetwork``).

    ``restore_multi_layer_network`` auto-detects upstream DL4J zips
    (configuration.json + coefficients.bin) alongside the port's own
    format; ``write_model_upstream_format`` exports back to it."""

    write_model = staticmethod(save_model)
    writeModel = staticmethod(save_model)
    write_model_upstream_format = staticmethod(write_model_upstream_format)
    write_computation_graph_upstream_format = staticmethod(
        write_computation_graph_upstream_format)
    restore_multi_layer_network = staticmethod(load_model)
    restoreMultiLayerNetwork = staticmethod(load_model)
    restore_computation_graph = staticmethod(load_model)
    restoreComputationGraph = staticmethod(load_model)
    restore_normalizer = staticmethod(restore_normalizer)
    restoreNormalizer = staticmethod(restore_normalizer)


__all__ = [
    "ModelSerializer", "OrbaxCheckpointer", "PreemptionWatchdog",
    "is_upstream_format", "load_model", "load_params",
    "restore_normalizer", "restore_upstream_computation_graph",
    "restore_upstream_multi_layer_network", "save_model",
    "write_computation_graph_upstream_format", "write_model_upstream_format",
]
