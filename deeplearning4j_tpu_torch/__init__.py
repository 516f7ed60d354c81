"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

A second package beside the JAX one, held against it by parity tests on
shared weights. It imports ``torch`` and ``numpy`` only: never ``jax``
and nothing of ``deeplearning4j_tpu``. The kernels the JAX package wrote
in Pallas for the TPU are CUDA C++ here (``csrc/``), built with ``nvcc``
at first use and bound with ``ctypes``.

What is ported so far is the serving path of the Transformer-LM:

- ``zoo.transformer`` — config, params, the inference forward, ``generate``;
- ``kernels.flash_attention`` — the causal flash-attention forward (K1);
- ``kernels.paged_attention`` — the paged-KV decode kernel (K2);
- ``serving.kvcache`` / ``serving.engine`` / ``serving.scheduler`` — dense
  and paged KV pools, the generation engine and continuous batching.

Entry points take ``device=None``, which means the CUDA card; without one
they raise unless the caller passed ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
