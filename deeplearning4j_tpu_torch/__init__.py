"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

A second package beside the JAX one, held against it by parity tests on
shared weights. It imports ``torch`` and ``numpy`` only: never ``jax``
and nothing of ``deeplearning4j_tpu``. The kernels the JAX package wrote
in Pallas for the TPU are CUDA C++ here (``csrc/``), built with ``nvcc``
at first use and bound with ``ctypes``.

What is ported so far:

- ``zoo.transformer`` — the Transformer-LM: config, params, forward,
  ``generate``, and training (``lm_loss``, remat, ``make_train_step``);
- ``kernels.flash_attention`` — flash attention forward (K1) and its dQ
  and dK/dV backward kernels;
- ``kernels.paged_attention`` — the paged-KV decode kernel (K2);
- ``serving.kvcache`` / ``serving.engine`` / ``serving.scheduler`` — dense
  and paged KV pools, the generation engine and continuous batching;
- ``nn``, ``train``, ``data``, ``zoo.resnet`` — the DL4J layer API that
  ResNet-50 needs, through ``ComputationGraph.fit`` / ``output``;
- ``kernels.fused_ops`` — fused BatchNorm + activation (K3): normalize,
  batch stats, backward reduce and backward dx kernels;
- ``nn.MultiLayerNetwork`` with the recurrent layers and LeNet, and
  ``kernels.fused_lstm`` — the whole-sequence LSTM kernel (K4);
- ``nn._compiled`` — the compiled step (the counterpart of ``jax.jit``
  with donation): ``fit``, ``fit_scanned``, the LM's ``make_train_step``
  and the serving engine's entry points replay CUDA graphs on the card,
  and :func:`disable_graphs` (the counterpart of ``jax.disable_jit``)
  keeps them eager;
- ``obs`` — the observability plane: the metrics registry, spans,
  request traces and the flight recorder, SLO tracking, the memory
  census, fidelity probes, and the compile sentinel around each of the
  engine's entry points (``engine.mark_warm()``,
  ``engine.compile_report()``) and the nets' train steps; the scheduler,
  the engine, the nets and ``nn.listeners.MetricsListener`` feed it;
- the DL4J workflow around ``fit``, inside the replayed step: ``eval``
  and the nets' ``evaluate*``, ``serde`` (``save``/``load``/``clone``,
  ``load_params``), ``nn.listeners`` with the deferred score read,
  ``train.schedules`` and all twelve updaters, ``train.constraints``,
  ``train.anomaly``, ``nn.weightnoise`` and the dropout family, and
  ``data.normalizers``;
- the rest of the DL4J workflow: ``nd`` (``ndarray/``: the ND4J
  factory, indexing, random keys as ``torch.Generator``s, workspaces as
  compiled callables), the data iterators with ``fit``'s async prefetch
  on the native ring (``data.async_iter``, ``utils.native``), the JAX
  package's updater state and normalizer read by ``serde.load_params`` /
  ``restore_normalizer``, ``remat_segments`` on both nets and ResNet-50,
  ``ComputationGraph.rnn_time_step`` and ``nn.early_stopping``;
- ``autodiff`` — SameDiff (the graph, all 739 ops of ``sd_ops``, grad,
  ``fit`` on the compiled step, save/load that reads the JAX package's
  zips, ``export``) and the TF GraphDef importer on its own wire reader;
- ``import_`` — the Keras importer (``.h5`` and ``.keras``) on the port's
  own HDF5 reader; ``serde.upstream_dl4j`` — the zips the Java DL4J
  writes, both ways; the SameDiff layers of ``nn``.

Entry points take ``device=None``, which means the CUDA card; without one
they raise unless the caller passed ``device="cpu"``.
"""

from . import ndarray as nd
from ._device import resolve_device
from .nn._compiled import disable_graphs

__all__ = ["disable_graphs", "nd", "resolve_device"]
