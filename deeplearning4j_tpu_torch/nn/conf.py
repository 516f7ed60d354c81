"""NeuralNetConfiguration — port of ``deeplearning4j_tpu/nn/conf.py``
(``NeuralNetConfiguration.Builder``, global defaults, their resolution
into each layer, and ``ListBuilder`` / ``MultiLayerConfiguration`` for
``MultiLayerNetwork``).

Global values (updater, weightInit, activation, l1/l2, dropout, dtype
policy) are defaults that individual layers may override. The dtype
policy takes torch dtypes: params in f32, compute in bf16 with
``.data_type(torch.float32, torch.bfloat16)``.

``MultiLayerConfiguration.to_json`` writes the configuration's fields as
JSON (dtypes by name); ``to_upstream_json`` / ``from_upstream_json``
(``fromJson``) are the upstream DL4J format of ``serde/upstream_dl4j.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from ..train.updaters import Sgd, Updater
from .layers.base import Layer


@dataclass
class GlobalConf:
    seed: int = 12345
    updater: Updater = field(default_factory=lambda: Sgd(1e-1))
    bias_updater: Optional[Updater] = None
    weight_init: Any = "xavier"
    activation: Any = None
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dropout: float = 0.0
    weight_noise: Any = None          # IWeightNoise (WeightNoise/DropConnect)
    grad_norm: str = "none"
    grad_norm_threshold: float = 1.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = None         # e.g. torch.bfloat16 for mixed precision
    mini_batch: bool = True
    max_num_line_search_iterations: int = 5  # accepted for config parity; unused
    weight_constraints: Any = None    # constrainWeights(...)
    bias_constraints: Any = None      # constrainBias(...)


class NeuralNetConfiguration:
    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._g = GlobalConf()

    # --- fluent setters (reference names, snake_case) ----------------------
    def seed(self, s):
        self._g.seed = int(s)
        return self

    def updater(self, u):
        self._g.updater = u
        return self

    def bias_updater(self, u):
        self._g.bias_updater = u
        return self

    def weight_init(self, wi):
        self._g.weight_init = wi
        return self

    def activation(self, a):
        self._g.activation = a
        return self

    def l1(self, v):
        self._g.l1 = float(v)
        return self

    def l2(self, v):
        self._g.l2 = float(v)
        return self

    def weight_decay(self, v):
        self._g.weight_decay = float(v)
        return self

    def drop_out(self, retain_prob):
        """DL4J semantics: argument is the RETAIN probability."""
        self._g.dropout = 1.0 - float(retain_prob)
        return self

    def dropout_rate(self, rate):
        self._g.dropout = float(rate)
        return self

    def weight_noise(self, wn):
        """DL4J Builder.weightNoise(IWeightNoise) — WeightNoise/DropConnect."""
        self._g.weight_noise = wn
        return self

    def gradient_normalization(self, gn):
        self._g.grad_norm = gn
        return self

    def gradient_normalization_threshold(self, t):
        self._g.grad_norm_threshold = float(t)
        return self

    def data_type(self, param_dtype, compute_dtype=None):
        self._g.param_dtype = param_dtype
        self._g.compute_dtype = compute_dtype
        return self

    def mini_batch(self, b):
        self._g.mini_batch = bool(b)
        return self

    def constrain_weights(self, *constraints):
        self._g.weight_constraints = list(constraints)
        return self

    def constrain_bias(self, *constraints):
        self._g.bias_constraints = list(constraints)
        return self

    def constrain_all_parameters(self, *constraints):
        self._g.weight_constraints = list(constraints)
        self._g.bias_constraints = list(constraints)
        return self

    # no-op parity shims (accepted, irrelevant here)
    def optimization_algo(self, *_):
        return self

    def cache_mode(self, *_):
        return self

    def cudnn_algo_mode(self, *_):
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def graph_builder(self):
        from .graph import GraphBuilder
        return GraphBuilder(self._g)


def resolve_layer_defaults(layer: Layer, g: GlobalConf) -> Layer:
    """Apply global defaults where the layer didn't specify (reference
    precedence: layer > global)."""
    if layer.weight_init is None:
        layer.weight_init = g.weight_init
    if getattr(layer, "activation", "__missing__") is None:
        layer.activation = g.activation or "identity"
    if layer.l1 == 0.0 and g.l1:
        layer.l1 = g.l1
    if layer.l2 == 0.0 and g.l2:
        layer.l2 = g.l2
    if layer.dropout == 0.0 and g.dropout and layer.has_params():
        layer.dropout = g.dropout
    if layer.weight_noise is None and g.weight_noise is not None \
            and layer.has_params():
        layer.weight_noise = g.weight_noise
    if layer.constraints is None and g.weight_constraints:
        layer.constraints = list(g.weight_constraints)
    if layer.bias_constraints is None and g.bias_constraints:
        layer.bias_constraints = list(g.bias_constraints)
    layer.dtype = g.param_dtype if layer.dtype is torch.float32 \
        else layer.dtype
    if layer.compute_dtype is None and g.compute_dtype is not None:
        layer.compute_dtype = g.compute_dtype
    # wrapped layers (Bidirectional, LastTimeStep, TimeDistributed)
    for attr in ("fwd", "inner"):
        sub = getattr(layer, attr, None)
        if isinstance(sub, Layer):
            resolve_layer_defaults(sub, g)
    return layer


class ListBuilder:
    """``NeuralNetConfiguration.builder().list()``: a stack of layers."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[Layer] = []
        self._input_type = None

    def layer(self, *args):
        """.layer(L) or .layer(index, L) (index must be append-order)."""
        self._layers.append(args[-1])
        return self

    def set_input_type(self, it):
        self._input_type = it
        return self

    input_type = set_input_type

    # accepted for parity, no effect (truncated BPTT is not modelled)
    def backprop_type(self, *_):
        return self

    def t_bptt_length(self, *_):
        return self

    def build(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            self._g, [copy.deepcopy(l) for l in self._layers],
            self._input_type)


@dataclass
class MultiLayerConfiguration:
    globals_: GlobalConf
    layers: List[Layer]
    input_type: Any = None

    def __post_init__(self):
        for lyr in self.layers:
            resolve_layer_defaults(lyr, self.globals_)

    def to_json(self) -> str:
        """The configuration as JSON: each dataclass as its fields and
        ``__class__``, tensors as ``{"__array__": true}``, dtypes by name."""
        def enc(o):
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                d = {"__class__": type(o).__name__}
                for f in dataclasses.fields(o):
                    d[f.name] = enc(getattr(o, f.name))
                return d
            if isinstance(o, (list, tuple)):
                return [enc(v) for v in o]
            if isinstance(o, dict):
                return {k: enc(v) for k, v in o.items()}
            if isinstance(o, torch.dtype):
                return {"__dtype__": str(o).rsplit(".", 1)[-1]}
            if hasattr(o, "dtype") and hasattr(o, "shape"):
                return {"__array__": True}
            return o
        return json.dumps({"globals": enc(self.globals_),
                           "input_type": self.input_type,
                           "layers": [enc(l) for l in self.layers]},
                          indent=2, default=str)

    def to_upstream_json(self) -> str:
        """Upstream ``MultiLayerConfiguration.toJson()``-format JSON
        (serde/upstream_dl4j.py, supported-layer subset)."""
        from ..serde.upstream_dl4j import mln_conf_to_upstream_json
        return mln_conf_to_upstream_json(self)

    @staticmethod
    def from_upstream_json(data: str) -> "MultiLayerConfiguration":
        """Upstream ``MultiLayerConfiguration.fromJson()`` analogue."""
        from ..serde.upstream_dl4j import mln_conf_from_upstream_json
        return mln_conf_from_upstream_json(data)

    fromJson = from_upstream_json      # reference naming
