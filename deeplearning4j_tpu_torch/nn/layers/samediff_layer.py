"""Custom layers defined through the SameDiff graph API — port of
``deeplearning4j_tpu/nn/layers/samediff_layer.py``.

Reference parity: ``org.deeplearning4j.nn.conf.layers.samediff`` —
`SameDiffLayer` (defineLayer/defineParameters/initializeParameters),
`SameDiffLambdaLayer`, `SameDiffOutputLayer` (defineLayer returns the loss,
activationsVertexName selects the inference output), `SameDiffVertex` and
`SameDiffLambdaVertex` (multi-input ComputationGraph vertices).

The user's ``define_layer`` builds a :class:`SameDiff` graph once per
device, lowered by ``SameDiff.make_function`` to a plain function of
(params, inputs) that runs inside the surrounding network's forward, so
autograd differentiates straight through the user graph and a captured
train step replays it with the rest of the net. Output shapes come from
one call on a zero probe on the host. A graph whose nodes need the host
while they run (``SameDiff.needs_host``: a ``while_loop`` or ``cond``
predicate, an assert, a random draw, a data-dependent shape) makes the
network run its steps eagerly, by the rule ``SameDiff.eval`` follows
(``needs_host()`` below; the networks ask it).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ...autodiff.samediff import SameDiff
from ..vertices import GraphVertex
from .base import Ctx, Layer

_PROBE_BATCH = 2


class SDLayerParams:
    """Parameter-shape registry handed to `define_parameters`.

    Reference: ``SDLayerParams.addWeightParam/addBiasParam``. Weights get the
    layer's weight_init; biases get bias_init.
    """

    def __init__(self):
        self.weight_shapes: Dict[str, Tuple[int, ...]] = {}
        self.bias_shapes: Dict[str, Tuple[int, ...]] = {}

    def add_weight_param(self, name: str, *shape):
        self.weight_shapes[name] = tuple(int(s) for s in shape)

    def add_bias_param(self, name: str, *shape):
        self.bias_shapes[name] = tuple(int(s) for s in shape)

    # pythonic aliases
    add_weight = add_weight_param
    add_bias = add_bias_param


def _build_graph(define, param_names, device, *, n_inputs=1,
                 with_mask=False, with_labels=False):
    """Build the user graph once on ``device`` and lower it to a plain
    function fn(var_values, *feeds); feeds order is inputs, then labels,
    then mask. Returns (fn, needs_host)."""
    sd = SameDiff.create(device=device)
    inputs = [sd.placeholder(f"input{i}" if n_inputs > 1 else "input")
              for i in range(n_inputs)]
    pvars = {n: sd.var(n, value=torch.zeros(())) for n in param_names}
    labels = sd.placeholder("labels") if with_labels else None
    mask = sd.placeholder("mask") if with_mask else None
    out = define(sd, inputs, pvars, labels, mask)
    placeholders = [v.name for v in inputs]
    if with_labels:
        placeholders.append("labels")
    if with_mask:
        placeholders.append("mask")
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    fn = sd.make_function(outs if len(outs) > 1 else outs[0], placeholders)
    return fn, sd.needs_host(outs)


def needs_host(layers) -> bool:
    """True when one of ``layers`` (layers or graph vertices) has a
    SameDiff graph that needs the host while it runs."""
    return any(getattr(layer, "needs_host", lambda: False)()
               for layer in layers)


def _probe(shape, dtype):
    return torch.zeros((_PROBE_BATCH,) + tuple(shape), dtype=dtype)


@dataclass
class _SDGraphModule(Layer):
    """Shared machinery: param registry, default init, pickle-safe fn cache."""

    def define_parameters(self, params: SDLayerParams) -> None:
        pass

    def initialize_parameters(self, gen, name, shape, kind):
        if kind == "bias":
            return torch.full(shape, self.bias_init, dtype=self.dtype)
        return self._make_weight(gen, shape)

    def __getstate__(self):
        # the lowered-graph cache holds closures — rebuilt lazily after a
        # load or a copy (deepcopy goes through here too)
        d = dict(self.__dict__)
        d.pop("_sd_fns", None)
        return d

    def _param_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        reg = SDLayerParams()
        self.define_parameters(reg)
        shapes = {n: (s, "weight") for n, s in reg.weight_shapes.items()}
        shapes.update({n: (s, "bias") for n, s in reg.bias_shapes.items()})
        return shapes

    def _init_params(self, gen):
        return {name: self.initialize_parameters(gen, name, shape, kind)
                for name, (shape, kind) in sorted(self._param_shapes().items())}

    def _fn_cache(self):
        return self.__dict__.setdefault("_sd_fns", {})

    def _graph(self, key, device, build):
        """The (fn, needs_host) of graph ``key`` on ``device``, built once."""
        cache = self._fn_cache()
        k = key + (str(torch.device(device)),)
        if k not in cache:
            cache[k] = build(torch.device(device))
        return cache[k]


@dataclass
class SameDiffLayer(_SDGraphModule):
    """Base for user-defined layers built from a SameDiff graph.

    Subclass and override:
      - ``define_parameters(params: SDLayerParams)`` — declare param shapes
      - ``define_layer(sd, layer_input, params, mask=None) -> SDVariable``
      - optionally ``initialize_parameters(gen, name, shape, kind)`` per-param
    """

    def define_layer(self, sd: SameDiff, layer_input, params, mask=None):
        raise NotImplementedError

    def _accepts_mask(self) -> bool:
        return "mask" in inspect.signature(self.define_layer).parameters

    def _fn(self, masked: bool, device="cpu", host=False):
        names = list(self._param_shapes())

        def define(sd, inputs, pvars, labels, mask):
            if masked:
                return self.define_layer(sd, inputs[0], pvars, mask=mask)
            return self.define_layer(sd, inputs[0], pvars)

        return self._graph(("layer", masked), device, lambda dev: _build_graph(
            define, names, dev, with_mask=masked))[1 if host else 0]

    def needs_host(self) -> bool:
        """True when the user graph needs the host while it runs (the
        network then runs its steps eagerly)."""
        return self._fn(False, host=True)

    def init(self, gen, input_shape):
        params = self._init_params(gen)
        with torch.no_grad():
            out = self._fn(masked=False)(params,
                                         _probe(input_shape, self.dtype))
        return params, {}, tuple(out.shape[1:])

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        # a define_layer without a mask= parameter ignores the feature mask —
        # the same semantics as built-in layers (DenseLayer etc. leave masks
        # to the loss) and the reference's null-mask defineLayer contract
        if ctx.mask is not None and self._accepts_mask():
            y = self._fn(True, x.device)(params, x, ctx.mask)
        else:
            y = self._fn(False, x.device)(params, x)
        return y, state


@dataclass
class SameDiffLambdaLayer(SameDiffLayer):
    """Param-free SameDiff layer from a ``fn(sd, layer_input)`` callable
    (or override ``define_layer``). Reference: SameDiffLambdaLayer.
    Note: to survive ModelSerializer pickling, pass a module-level function,
    not a lambda."""

    fn: Optional[Callable] = None

    def define_layer(self, sd, layer_input, params, mask=None):
        if self.fn is None:
            raise NotImplementedError(
                "pass fn=lambda sd, x: ... or override define_layer")
        return self.fn(sd, layer_input)

    def has_params(self):
        return False


@dataclass
class SameDiffOutputLayer(_SDGraphModule):
    """Output layer whose loss is a SameDiff graph.

    Override ``define_layer(sd, layer_input, labels, params)`` (optionally
    with a ``mask=None`` kwarg to receive the labels mask) returning a scalar
    loss SDVariable, and ``activations_vertex_name() -> str`` naming the
    graph variable that `output()` should return (it must not depend on
    labels). Reference: SameDiffOutputLayer.
    """

    def define_layer(self, sd, layer_input, labels, params):  # -> loss var
        raise NotImplementedError

    def activations_vertex_name(self) -> str:
        raise NotImplementedError

    def _accepts_mask(self) -> bool:
        return "mask" in inspect.signature(self.define_layer).parameters

    def _out_fns(self, masked: bool = False, device="cpu"):
        """(loss-and-activations fn, activations fn, needs_host)."""
        names = list(self._param_shapes())

        def build(dev):
            holder = {}

            def define(sd, inputs, pvars, labels, mask):
                if masked:
                    loss = self.define_layer(sd, inputs[0], labels, pvars,
                                             mask=mask)
                else:
                    loss = self.define_layer(sd, inputs[0], labels, pvars)
                act = sd.get_variable(self.activations_vertex_name())
                holder["act"] = act
                return [loss, act]

            fn, host = _build_graph(define, names, dev, with_labels=True,
                                    with_mask=masked)
            # activations-only function over the same graph: the labels/mask
            # placeholders are never fed because activations can't depend
            # on them
            sd = holder["act"].sd
            return fn, sd.make_function(holder["act"], ["input"]), host
        return self._graph(("out", masked), device, build)

    def needs_host(self) -> bool:
        return self._out_fns()[2]

    def init(self, gen, input_shape):
        params = self._init_params(gen)
        _, act_fn, _ = self._out_fns()
        with torch.no_grad():
            out = act_fn(params, _probe(input_shape, self.dtype))
        return params, {}, tuple(out.shape[1:])

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        _, act_fn, _ = self._out_fns(device=x.device)
        return act_fn(params, x), state

    def compute_loss(self, params, x, labels, mask=None):
        x = self._cast_in(x)
        if mask is not None:
            if not self._accepts_mask():
                raise ValueError(
                    f"{type(self).__name__}: a labels mask was supplied but "
                    "define_layer has no mask= parameter — add one to handle "
                    "masked losses (silently ignoring it would train wrong)")
            fn, _, _ = self._out_fns(True, x.device)
            loss, _ = fn(params, x, labels, mask)
            return loss
        fn, _, _ = self._out_fns(device=x.device)
        loss, _ = fn(params, x, labels)
        return loss


@dataclass
class SameDiffVertex(_SDGraphModule):
    """Multi-input, parameterized ComputationGraph vertex defined via a
    SameDiff graph. Override ``define_parameters`` and
    ``define_vertex(sd, inputs: list, params) -> SDVariable``.
    Reference: SameDiffVertex."""

    multi_input = True

    def define_vertex(self, sd, inputs: List, params):
        raise NotImplementedError

    def _fn(self, n_inputs: int, device="cpu"):
        names = list(self._param_shapes())

        def define(sd, inputs, pvars, labels, mask):
            return self.define_vertex(sd, list(inputs), pvars)

        return self._graph(("vertex", n_inputs), device, lambda dev:
                           _build_graph(define, names, dev,
                                        n_inputs=n_inputs))

    def needs_host(self) -> bool:
        return any(v[1] for k, v in self._fn_cache().items()
                   if k[0] == "vertex")

    def init(self, gen, input_shapes):
        # input_shapes: list of per-input shapes (batch-less)
        if input_shapes and not isinstance(input_shapes[0], (tuple, list)):
            input_shapes = [input_shapes]
        params = self._init_params(gen)
        fn, _ = self._fn(len(input_shapes))
        with torch.no_grad():
            out = fn(params, *[_probe(s, self.dtype) for s in input_shapes])
        return params, {}, tuple(out.shape[1:])

    def apply(self, params, state, xs, ctx: Ctx):
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        xs = [self._cast_in(x) for x in xs]
        return self._fn(len(xs), xs[0].device)[0](params, *xs), state


class SameDiffLambdaVertex(GraphVertex):
    """Param-free multi-input vertex from ``fn(sd, *inputs)``.
    Reference: SameDiffLambdaVertex."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._fns = {}

    def __getstate__(self):
        return {"fn": self.fn}

    def __setstate__(self, d):
        self.fn = d["fn"]
        self._fns = {}

    def _fn(self, n_inputs, device="cpu"):
        key = (n_inputs, str(torch.device(device)))
        if key not in self._fns:
            def define(sd, inputs, pvars, labels, mask):
                return self.fn(sd, *inputs)

            self._fns[key] = _build_graph(define, [], torch.device(device),
                                          n_inputs=n_inputs)
        return self._fns[key]

    def needs_host(self) -> bool:
        return any(host for _, host in self._fns.values())

    def out_shape(self, shapes):
        fn, _ = self._fn(len(shapes))
        with torch.no_grad():
            out = fn({}, *[_probe(s, torch.float32) for s in shapes])
        return tuple(out.shape[1:])

    def apply(self, inputs, ctx=None):
        return self._fn(len(inputs), inputs[0].device)[0]({}, *inputs)
