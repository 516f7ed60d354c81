"""Adapter: serve a pure-functional forward through ``ParallelInference``
— port of ``deeplearning4j_tpu/serving/adapter.py``.

The zoo's functional models (the Transformer-LM, BERT) are params + fn
pairs, not ``MultiLayerNetwork``/``ComputationGraph`` objects. This shim
gives a functional forward the attributes ``ParallelInference`` uses
(``params``, ``states``, ``conf.nodes``, ``_forward``) and nothing else;
the params land under one ``"model"`` key.

    bert = FunctionalInferenceModel(
        params, lambda p, ids: tfm.bert_forward(p, cfg, ids)[0])
    pi = ParallelInference(bert, max_batch=8, max_wait_ms=5.0)
    logits = pi.output(ids)          # or pi.submit(ids) for batching
"""

from __future__ import annotations


class _EmptyConf:
    """Just enough of a net conf: no layer nodes."""
    nodes: dict = {}


class FunctionalInferenceModel:
    """Wrap ``forward(params, x) -> y`` for ``ParallelInference``."""

    def __init__(self, params, forward):
        self.params = {"model": params}
        self.states = {}
        self.conf = _EmptyConf()
        self._fwd = forward
        self.initialized = True

    def _forward(self, params, states, x, train=False, rng=None):
        return self._fwd(params["model"], x), states
