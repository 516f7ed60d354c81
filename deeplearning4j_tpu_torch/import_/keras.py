"""Keras .h5 / .keras model import — port of
``deeplearning4j_tpu/import_/keras.py`` (``deeplearning4j-modelimport``:
``KerasModelImport.importKerasSequentialModelAndWeights`` /
``importKerasModelAndWeights``).

Reads the HDF5 ``model_config`` JSON and the weight groups with the port's
own HDF5 reader (``_hdf5.py``; neither h5py nor TensorFlow is imported),
builds a MultiLayerNetwork (Sequential) or a ComputationGraph
(Functional) on ``device`` (None → CUDA), and copies the weights into its
tensors with the reference's layout conversions:

- Dense kernel (in, out) → (in, out) as-is
- Conv2D kernel (kh, kw, cin, cout) → HWIO as-is (both NHWC)
- Conv2DTranspose kernel (kh, kw, cout, cin) → flipped and transposed to
  HWIO
- DepthwiseConv2D / SeparableConv2D depthwise kernel (kh, kw, cin, mult)
  → (kh, kw, 1, cin*mult); output-channel order cin*mult+m matches
- LSTM kernels: keras gate order [i, f, c, o] → ours [i, f, o, g(c)]
- GRU kernels: keras [z, r, h] → ours [r, z, n]; reset_after bias → ``rb``
- BatchNorm: gamma/beta/moving_mean/moving_variance → params + state

Functional models (keras 2 and keras 3 inbound-node formats) become a
ComputationGraph: merge layers → Merge/ElementWise vertices, Flatten → a
CnnToFeedForward preprocessor vertex. A Lambda layer or an unmapped class
needs a registered torch function or factory, as the reference needs a
JAX one.
"""

from __future__ import annotations

import json
import re
import types
from contextlib import contextmanager as _contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import _hdf5
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType, Layer
from ..nn.layers.conv import (Convolution1DLayer, Convolution3DLayer,
                              ConvolutionLayer, Cropping1D, Cropping2D,
                              Cropping3D, Deconvolution2D, Deconvolution3D,
                              DepthwiseConvolution2D, GlobalPoolingLayer,
                              SeparableConvolution2D, Subsampling1DLayer,
                              Subsampling3DLayer, SubsamplingLayer,
                              Upsampling1D, Upsampling2D, Upsampling3D,
                              ZeroPadding1DLayer, ZeroPadding3DLayer,
                              ZeroPaddingLayer)
from ..nn.layers.core import (ActivationLayer, AlphaDropout, DenseLayer,
                              DropoutLayer, EmbeddingSequenceLayer,
                              GaussianDropout, GaussianNoise, PermuteLayer,
                              PReLULayer, ReshapeLayer, SpatialDropout)
from ..nn.layers.norm import BatchNormalization, LayerNormalization
from ..nn.layers.recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D,
                                   LastTimeStep, SimpleRnn)
from ..nn.layers.wrappers import RepeatVector, TimeDistributedLayer
from ..nn.multi_layer_network import MultiLayerNetwork
from ..nn.preprocessors import CnnToFeedForwardPreProcessor
from ..nn.vertices import ElementWiseVertex, MergeVertex, PreprocessorVertex

_ACT = {"relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh",
        "softmax": "softmax", "linear": "identity", "elu": "elu",
        "selu": "selu", "gelu": "gelu", "softplus": "softplus",
        "softsign": "softsign", "swish": "swish", "silu": "swish",
        "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
        "relu6": "relu6", "mish": "mish", "exponential": "identity"}

_ELEMENTWISE = {"Add": "add", "Subtract": "sub", "Multiply": "mul",
                "Average": "avg", "Maximum": "max"}

# --------------------------------------------- custom layer / Lambda registry
# Reference parity: KerasLayer.registerCustomLayer(name, class) and
# KerasLambdaLayer — Lambda bodies don't serialize portably, so the user
# registers a function for each Lambda layer NAME before importing.
_CUSTOM_LAYERS: Dict[str, Any] = {}
_LAMBDAS: Dict[str, Any] = {}


def register_custom_layer(class_name: str, factory, assign_weights=None):
    """Register ``factory(keras_layer_config_dict) -> Layer`` for a keras
    ``class_name`` the importer doesn't map (reference registerCustomLayer).

    For custom layers WITH trainable weights, also pass
    ``assign_weights(layer, params_dict, state_dict, weight_arrays)``
    (numpy arrays in; put tensors into the dicts) — importing a weighted
    custom layer without it raises rather than silently keeping random
    init."""
    _CUSTOM_LAYERS[class_name] = (factory, assign_weights)


def register_lambda(layer_name: str, fn):
    """Register the torch function for a keras ``Lambda`` layer, keyed by
    the LAYER NAME (reference KerasLayer.registerLambdaLayer). ``fn(x) ->
    y`` takes and returns tensors; the output shape is found by calling
    it on a zero probe on the host."""
    _LAMBDAS[layer_name] = fn


def clear_custom_layers():
    _CUSTOM_LAYERS.clear()
    _LAMBDAS.clear()


@dataclass
class KerasLambdaLayer(Layer):
    """Parameter-free layer wrapping a user-registered torch function —
    the SameDiffLambdaLayer analogue."""

    fn: Any = None
    lambda_name: str = ""

    def init(self, gen, input_shape):
        # probe dynamic (None) dims — common for variable-length RNN input —
        # then restore None where the fn preserved the probed extent
        probe = tuple(4 if d is None else d for d in input_shape)
        try:
            with torch.no_grad():
                out = self.fn(torch.zeros((1,) + probe, dtype=self.dtype))
        except Exception as e:  # noqa: BLE001 — surface as an import error
            raise ValueError(
                f"Lambda '{self.lambda_name}': output-shape inference failed "
                f"for input shape {input_shape}: {e}") from e
        out_shape = tuple(out.shape[1:])
        if len(out_shape) == len(probe):
            out_shape = tuple(
                None if d is None and o == p else o
                for d, p, o in zip(input_shape, probe, out_shape))
        return {}, {}, out_shape

    def apply(self, params, state, x, ctx):
        return self.fn(x), state

    def has_params(self):
        return False


def _act(cfg):
    return _ACT.get(cfg.get("activation", "linear"), "identity")


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _one(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _trip(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


def _mode(c):
    return "same" if c.get("padding", "valid") == "same" else "truncate"


def _map_layer(kcfg: dict):
    """keras layer config dict → our layer (or None for structural layers)."""
    cls = kcfg["class_name"]
    c = kcfg["config"]
    if cls in _CUSTOM_LAYERS:              # user registry wins (reference
        factory, assign = _CUSTOM_LAYERS[cls]   # registerCustomLayer)
        layer = factory(kcfg)
        layer._keras_custom = cls
        layer._keras_assign = assign
        return layer
    if cls == "Lambda":
        name = c.get("name", "")
        if name not in _LAMBDAS:
            raise NotImplementedError(
                f"Lambda layer '{name}': python lambda bodies don't "
                "serialize portably — register_lambda("
                f"{name!r}, fn) before importing (the reference requires "
                "a SameDiffLambdaLayer the same way)")
        return KerasLambdaLayer(fn=_LAMBDAS[name], lambda_name=name)
    if cls == "Dense":
        return DenseLayer(n_out=c["units"], activation=_act(c),
                          has_bias=c.get("use_bias", True))
    if cls == "Conv2D":
        return ConvolutionLayer(
            n_out=c["filters"], kernel_size=_pair(c["kernel_size"]),
            stride=_pair(c.get("strides", 1)),
            dilation=_pair(c.get("dilation_rate", 1)),
            convolution_mode=_mode(c), padding=0, activation=_act(c),
            has_bias=c.get("use_bias", True))
    if cls == "Conv2DTranspose":
        return Deconvolution2D(
            n_out=c["filters"], kernel_size=_pair(c["kernel_size"]),
            stride=_pair(c.get("strides", 1)), convolution_mode=_mode(c),
            padding=0, activation=_act(c), has_bias=c.get("use_bias", True))
    if cls == "SeparableConv2D":
        return SeparableConvolution2D(
            n_out=c["filters"], kernel_size=_pair(c["kernel_size"]),
            stride=_pair(c.get("strides", 1)),
            depth_multiplier=c.get("depth_multiplier", 1),
            convolution_mode=_mode(c), padding=0, activation=_act(c),
            has_bias=c.get("use_bias", True))
    if cls == "DepthwiseConv2D":
        return DepthwiseConvolution2D(
            kernel_size=_pair(c["kernel_size"]),
            stride=_pair(c.get("strides", 1)),
            depth_multiplier=c.get("depth_multiplier", 1),
            convolution_mode=_mode(c), padding=0, activation=_act(c),
            has_bias=c.get("use_bias", True))
    if cls == "Conv1D":
        return Convolution1DLayer(
            n_out=c["filters"], kernel_size=_one(c["kernel_size"]),
            stride=_one(c.get("strides", 1)),
            dilation=_one(c.get("dilation_rate", 1)),
            convolution_mode=_mode(c), padding=0, activation=_act(c),
            has_bias=c.get("use_bias", True))
    if cls == "Conv3D":
        return Convolution3DLayer(
            n_out=c["filters"], kernel_size=_trip(c["kernel_size"]),
            stride=_trip(c.get("strides", 1)),
            dilation=_trip(c.get("dilation_rate", 1)),
            convolution_mode=_mode(c), padding=0, activation=_act(c),
            has_bias=c.get("use_bias", True))
    if cls == "Conv3DTranspose":
        return Deconvolution3D(
            n_out=c["filters"], kernel_size=_trip(c["kernel_size"]),
            stride=_trip(c.get("strides", 1)), convolution_mode=_mode(c),
            padding=0, activation=_act(c), has_bias=c.get("use_bias", True))
    if cls == "ConvLSTM2D":
        return ConvLSTM2D(
            n_out=c["filters"], kernel_size=_pair(c["kernel_size"]),
            stride=_pair(c.get("strides", 1)), convolution_mode=_mode(c),
            activation=_act({"activation": c.get("activation", "tanh")}),
            gate_activation=_ACT.get(c.get("recurrent_activation", "sigmoid"),
                                     "sigmoid"),
            forget_gate_bias=(1.0 if c.get("unit_forget_bias", True) else 0.0),
            return_sequences=c.get("return_sequences", False),
            has_bias=c.get("use_bias", True))
    if cls in ("MaxPooling3D", "AveragePooling3D"):
        return Subsampling3DLayer(
            kernel_size=_trip(c.get("pool_size", 2)),
            stride=_trip(c.get("strides") or c.get("pool_size", 2)),
            pooling_type="max" if cls.startswith("Max") else "avg",
            convolution_mode=_mode(c))
    if cls == "UpSampling3D":
        return Upsampling3D(size=_trip(c.get("size", 2)))
    if cls == "ZeroPadding3D":
        return ZeroPadding3DLayer(padding=c.get("padding", 1))
    if cls == "Cropping3D":
        return Cropping3D(cropping=c.get("cropping", 1))
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            kernel_size=_pair(c.get("pool_size", 2)),
            stride=_pair(c.get("strides") or c.get("pool_size", 2)),
            pooling_type="max" if cls.startswith("Max") else "avg",
            convolution_mode=_mode(c))
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        return Subsampling1DLayer(
            kernel_size=_one(c.get("pool_size", 2)),
            stride=_one(c.get("strides") or c.get("pool_size", 2)),
            pooling_type="max" if cls.startswith("Max") else "avg",
            convolution_mode=_mode(c))
    if cls in ("GlobalAveragePooling3D", "GlobalAveragePooling2D",
               "GlobalAveragePooling1D"):
        return GlobalPoolingLayer(pooling_type="avg")
    if cls in ("GlobalMaxPooling3D", "GlobalMaxPooling2D",
               "GlobalMaxPooling1D"):
        return GlobalPoolingLayer(pooling_type="max")
    if cls == "UpSampling2D":
        return Upsampling2D(size=_pair(c.get("size", 2)))
    if cls == "UpSampling1D":
        return Upsampling1D(size=_one(c.get("size", 2)))
    if cls == "ZeroPadding2D":
        return ZeroPaddingLayer(padding=c.get("padding", (1, 1)))
    if cls == "ZeroPadding1D":
        return ZeroPadding1DLayer(padding=c.get("padding", 1))
    if cls == "Cropping2D":
        return Cropping2D(cropping=c.get("cropping", (1, 1)))
    if cls == "Cropping1D":
        return Cropping1D(cropping=c.get("cropping", 1))
    if cls == "Dropout":
        return DropoutLayer(rate=c["rate"])
    if cls == "SpatialDropout2D":
        return SpatialDropout(rate=c["rate"])
    if cls == "GaussianDropout":
        return GaussianDropout(rate=c["rate"])
    if cls == "GaussianNoise":
        return GaussianNoise(stddev=c.get("stddev", 0.1))
    if cls == "AlphaDropout":
        return AlphaDropout(rate=c["rate"])
    if cls == "Activation":
        return ActivationLayer(activation=_act(c))
    if cls == "ReLU":
        return ActivationLayer(activation="relu")
    if cls == "LeakyReLU":
        return ActivationLayer(activation="leakyrelu")
    if cls == "ELU":
        return ActivationLayer(activation="elu")
    if cls == "Softmax":
        return ActivationLayer(activation="softmax")
    if cls == "PReLU":
        return PReLULayer()
    if cls == "BatchNormalization":
        return BatchNormalization(eps=c.get("epsilon", 1e-3),
                                  decay=c.get("momentum", 0.99))
    if cls == "LayerNormalization":
        return LayerNormalization(eps=c.get("epsilon", 1e-3))
    if cls == "Embedding":
        return EmbeddingSequenceLayer(n_in=c["input_dim"],
                                      n_out=c["output_dim"])
    if cls == "Reshape":
        return ReshapeLayer(target_shape=tuple(c["target_shape"]))
    if cls == "Permute":
        return PermuteLayer(dims=tuple(c["dims"]))
    if cls == "RepeatVector":
        return RepeatVector(n=c["n"])
    if cls == "TimeDistributed":
        inner_cls = c["layer"].get("class_name")
        inner = _map_layer(c["layer"])
        if inner is None:
            raise NotImplementedError(
                f"TimeDistributed({inner_cls}): structural inner layers "
                "(Flatten/InputLayer) have no per-timestep meaning")
        # the fold-time-into-batch wrapper is shape-generic, so spatial
        # inners (Conv2D per frame) map the same way as feed-forward ones
        return TimeDistributedLayer(layer=inner)
    if cls in ("LSTM", "GRU", "SimpleRNN"):
        if cls == "LSTM":
            rnn = LSTM(n_out=c["units"],
                       activation=_act({"activation":
                                        c.get("activation", "tanh")}),
                       gate_activation=_ACT.get(c.get("recurrent_activation",
                                                      "sigmoid"), "sigmoid"),
                       forget_gate_bias=0.0)
        elif cls == "GRU":
            rnn = GRU(n_out=c["units"],
                      gate_activation=_ACT.get(c.get("recurrent_activation",
                                                     "sigmoid"), "sigmoid"),
                      reset_after=c.get("reset_after", True))
        else:
            rnn = SimpleRnn(n_out=c["units"],
                            activation=_act({"activation":
                                             c.get("activation", "tanh")}))
        if not c.get("return_sequences", False):
            return LastTimeStep(rnn)
        return rnn
    if cls == "Bidirectional":
        sub = c["layer"]
        subc = dict(sub["config"])
        last_step = not subc.get("return_sequences", False)
        subc["return_sequences"] = True  # wrapper, not inner, takes last step
        inner = _map_layer({"class_name": sub["class_name"], "config": subc})
        mode = c.get("merge_mode", "concat")
        if mode == "sum":
            mode = "add"
        if mode is None:
            raise NotImplementedError(
                "Bidirectional merge_mode=None (separate outputs) is not "
                "supported; use concat/sum/ave/mul")
        if mode not in ("concat", "add", "mul", "ave", "average"):
            raise NotImplementedError(f"Bidirectional merge_mode '{mode}'")
        if mode == "ave":
            mode = "average"
        return Bidirectional(fwd=inner, mode=mode, last_step=last_step)
    if cls == "Flatten":
        return None  # auto preprocessor inserts the reshape
    if cls in ("InputLayer",):
        return None
    raise NotImplementedError(
        f"Keras layer '{cls}' not mapped yet — register_custom_layer("
        f"{cls!r}, factory) can supply a mapping (reference "
        "KerasLayer.registerCustomLayer)")


def _keras_input_type(kcfg):
    c = kcfg["config"]
    shape = c.get("batch_input_shape") or c.get("batch_shape")
    if shape is None:
        return None
    dims = tuple(d for d in shape[1:])
    if len(dims) == 4:  # (T,H,W,C) ConvLSTM sequences or (D,H,W,C) volumes
        return InputType.convolutional_3d(*dims)
    if len(dims) == 3:
        return InputType.convolutional(*dims)
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    return None


def _lstm_reorder(k, units):
    """keras [i, f, c, o] gate columns → ours [i, f, o, g]."""
    i, f, cc, o = (k[:, j * units:(j + 1) * units] for j in range(4))
    return np.concatenate([i, f, o, cc], axis=1)


def _gru_reorder(k, units):
    """keras [z, r, h] gate columns → ours [r, z, n]."""
    z, r, hh = (k[:, j * units:(j + 1) * units] for j in range(3))
    return np.concatenate([r, z, hh], axis=1)


def _convlstm_reorder(k, units):
    """keras ConvLSTM gate blocks [i, f, c, o] (last axis) → ours [i, f, o, g]."""
    i, f, cc, o = (k[..., j * units:(j + 1) * units] for j in range(4))
    return np.concatenate([i, f, o, cc], axis=-1)


def _depthwise_reshape(k):
    """keras (kh, kw, cin, mult) → HWIO (kh, kw, 1, cin*mult); keras's
    output-channel order cin*mult + m matches groups=cin."""
    kh, kw, cin, mult = k.shape
    return k.reshape(kh, kw, 1, cin * mult)


def _put(tree, key, arr):
    """Copy ``arr`` into ``tree[key]`` in place (the net's tensor keeps its
    device, dtype and grad flag); a key the layer did not make gets a new
    tensor beside the others."""
    src = torch.from_numpy(np.array(arr, np.float32, order="C"))
    old = tree.get(key)
    if isinstance(old, torch.Tensor):
        if tuple(old.shape) != tuple(src.shape):
            raise ValueError(f"keras weight {key!r} has shape "
                             f"{tuple(src.shape)}, the layer "
                             f"{tuple(old.shape)}")
        with torch.no_grad():
            old.copy_(src)
        return
    like = next((t for t in tree.values() if isinstance(t, torch.Tensor)),
                None)
    dev = like.device if like is not None else src.device
    tree[key] = src.to(dev).requires_grad_(like is not None
                                           and like.requires_grad)


def _set_layer_weights(layer, pdict: Dict, sdict: Dict, ws: List[np.ndarray]):
    """Write one keras layer's weight list into our (params, state) dicts."""
    if isinstance(layer, LastTimeStep):  # return_sequences=False wrapper
        layer = layer.inner
    if isinstance(layer, TimeDistributedLayer):   # weights live on the inner
        layer = layer.layer
    assign = getattr(layer, "_keras_assign", None)
    if assign is not None:
        assign(layer, pdict, sdict, ws)
        return
    if getattr(layer, "_keras_custom", None) and ws:
        raise ValueError(
            f"custom layer '{layer._keras_custom}' has {len(ws)} weight "
            "arrays in the h5 file but no assign_weights hook — importing "
            "would silently keep random init; pass register_custom_layer("
            f"{layer._keras_custom!r}, factory, assign_weights=...)")
    if isinstance(layer, KerasLambdaLayer):
        return  # parameter-free by construction
    if isinstance(layer, Bidirectional):
        # h5 weight_names order: forward [kernel, rec, bias] then backward
        half = len(ws) // 2
        _set_layer_weights(layer.fwd, pdict["fwd"], sdict.get("fwd", {}),
                           ws[:half])
        _set_layer_weights(layer.fwd, pdict["bwd"], sdict.get("bwd", {}),
                           ws[half:])
        return
    if isinstance(layer, DenseLayer):
        _put(pdict, "W", ws[0])
        if layer.has_bias and len(ws) > 1:
            _put(pdict, "b", ws[1])
    elif isinstance(layer, Deconvolution2D):
        # keras (kh,kw,cout,cin), gradient-of-conv semantics (flipped kernel)
        # → our unflipped HWIO transposed conv: flip spatial + swap I/O
        _put(pdict, "W", np.transpose(ws[0][::-1, ::-1], (0, 1, 3, 2)))
        if layer.has_bias and len(ws) > 1:
            _put(pdict, "b", ws[1])
    elif isinstance(layer, SeparableConvolution2D):
        _put(pdict, "dW", _depthwise_reshape(ws[0]))
        _put(pdict, "pW", ws[1])
        if layer.has_bias and len(ws) > 2:
            _put(pdict, "b", ws[2])
    elif isinstance(layer, DepthwiseConvolution2D):
        _put(pdict, "W", _depthwise_reshape(ws[0]))
        if layer.has_bias and len(ws) > 1:
            _put(pdict, "b", ws[1])
    elif isinstance(layer, Deconvolution3D):
        # keras (kd,kh,kw,cout,cin) gradient-of-conv (flipped) → our
        # unflipped DHWIO transposed conv: flip spatial + swap I/O
        _put(pdict, "W", np.transpose(ws[0][::-1, ::-1, ::-1],
                                      (0, 1, 2, 4, 3)))
        if layer.has_bias and len(ws) > 1:
            _put(pdict, "b", ws[1])
    elif isinstance(layer, ConvLSTM2D):
        units = layer.n_out
        kernel, rec, bias = ws[:3]
        _put(pdict, "W", _convlstm_reorder(kernel, units))
        _put(pdict, "RW", _convlstm_reorder(rec, units))
        if layer.has_bias and len(ws) > 2:
            _put(pdict, "b", _convlstm_reorder(bias[None, :], units)[0])
    elif isinstance(layer, (ConvolutionLayer, Convolution1DLayer,
                            Convolution3DLayer)):
        _put(pdict, "W", ws[0])  # HWIO / TIO / DHWIO as-is
        if layer.has_bias and len(ws) > 1:
            _put(pdict, "b", ws[1])
    elif isinstance(layer, BatchNormalization):
        gamma, beta, mean, var = ws[:4]
        _put(pdict, "gamma", gamma)
        _put(pdict, "beta", beta)
        _put(sdict, "mean", mean)
        _put(sdict, "var", var)
    elif isinstance(layer, LayerNormalization):
        _put(pdict, "gamma", ws[0])
        if len(ws) > 1:
            _put(pdict, "beta", ws[1])
    elif isinstance(layer, LSTM):
        units = layer.n_out
        kernel, rec, bias = ws[:3]
        _put(pdict, "W", _lstm_reorder(kernel, units))
        _put(pdict, "RW", _lstm_reorder(rec, units))
        if bias.ndim == 2:  # keras can stack [input_bias, recurrent_bias]
            bias = bias.sum(axis=0)
        _put(pdict, "b", _lstm_reorder(bias[None, :], units)[0])
    elif isinstance(layer, GRU):
        units = layer.n_out
        kernel, rec, bias = ws[:3]
        _put(pdict, "W", _gru_reorder(kernel, units))
        _put(pdict, "RW", _gru_reorder(rec, units))
        if bias.ndim == 2:  # reset_after=True: [input_bias, recurrent_bias]
            _put(pdict, "b", _gru_reorder(bias[0][None, :], units)[0])
            _put(pdict, "rb", _gru_reorder(bias[1][None, :], units)[0])
        else:
            _put(pdict, "b", _gru_reorder(bias[None, :], units)[0])
    elif isinstance(layer, SimpleRnn):
        _put(pdict, "W", ws[0])
        _put(pdict, "RW", ws[1])
        if len(ws) > 2:
            _put(pdict, "b", ws[2])
    elif isinstance(layer, PReLULayer):
        _put(pdict, "alpha", ws[0])
    elif isinstance(layer, EmbeddingSequenceLayer):
        _put(pdict, "W", ws[0])


def _weight_arrays(model_weights, lname):
    grp = model_weights[lname]
    names = [n.decode() if isinstance(n, bytes) else n
             for n in grp.attrs.get("weight_names", [])]
    if names:
        return [np.asarray(grp[n]) for n in names]
    found = []  # keras3 style: nested 'vars' datasets, integer-named

    def visit(name, obj):
        if isinstance(obj, _hdf5.Dataset):
            found.append((name, obj))
    grp.visititems(visit)

    # visititems yields lexicographic order ('10' < '2'); sort integer-like
    # path segments numerically so layers with 10+ variables stay ordered
    def sort_key(item):
        return tuple((0, int(seg)) if seg.isdigit() else (1, seg)
                     for seg in item[0].split("/"))

    return [np.asarray(obj) for _, obj in sorted(found, key=sort_key)]


def _assign_weights(net: MultiLayerNetwork, model_weights,
                    layer_names_in_order):
    """Copy weight arrays from the h5 group into net params/states."""
    for i, (layer, lname) in enumerate(zip(net.layers, layer_names_in_order)):
        if lname is None:
            continue
        ws = _weight_arrays(model_weights, lname)
        if not ws:
            continue
        key = f"layer_{i}"
        _set_layer_weights(layer, net.params[key], net.states[key], ws)


_KERAS_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "sparse_mcxent",
    "binary_crossentropy": "binary_xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kl_divergence": "kl_divergence",
    "kullback_leibler_divergence": "kl_divergence",
    "poisson": "poisson", "cosine_similarity": "cosine_proximity",
}


def _keras_to_snake(name: str) -> str:
    """keras.src to_snake_case: the rule behind v3 auto variable paths
    ('Conv2D' → 'conv2d', 'BatchNormalization' → 'batch_normalization')."""
    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


def _v3_auto_paths(layer_cfgs) -> Dict[str, str]:
    """Config layer name → the auto path keras-v3 keys its weights h5 by.

    model.weights.h5 groups are 'layers/<snake(class)>[_<k>]' in CREATION
    order per base name — the config's explicit layer names never appear
    (keras 3.13). Regenerating the counter sequence over the config's
    layer list (skipping InputLayer, which saves no group) reproduces the
    mapping."""
    counts: Dict[str, int] = {}
    out: Dict[str, str] = {}
    for kc in layer_cfgs:
        if kc["class_name"] == "InputLayer":
            continue
        base = _keras_to_snake(kc["class_name"])
        k = counts.get(base, 0)
        counts[base] = k + 1
        out[kc["config"]["name"]] = base if k == 0 else f"{base}_{k}"
    return out


class _V3Weights:
    """Presents a keras-v3 weights h5 with the legacy name-keyed interface
    the assignment code uses (config layer name → h5 group with vars/)."""

    def __init__(self, h5file, name_map: Dict[str, str]):
        self._layers = h5file.get("layers")
        self._map = name_map

    def keys(self):
        if self._layers is None:
            return []
        return [cfg_name for cfg_name, auto in self._map.items()
                if auto in self._layers]

    def __contains__(self, k):
        return self._layers is not None and self._map.get(k) in self._layers

    def __getitem__(self, k):
        return self._layers[self._map[k]]


@_contextmanager
def _model_source(path):
    """Context manager: (f-like with .attrs, weights-group-like) for BOTH
    the legacy .h5 layout and the keras-v3 .keras zip archive
    (config.json + model.weights.h5 + metadata.json)."""
    import zipfile as _zip

    if _zip.is_zipfile(path):
        with _zip.ZipFile(path) as zf:
            if "config.json" not in set(zf.namelist()):
                raise ValueError(f"{path} is a zip but not a .keras "
                                 "archive (no config.json)")
            cfg = json.loads(zf.read("config.json"))
            attrs = {"model_config": json.dumps(cfg)}
            if cfg.get("compile_config"):
                attrs["training_config"] = json.dumps(cfg["compile_config"])
            inner = cfg["config"]
            layer_cfgs = inner["layers"] if isinstance(inner, dict) else inner
            with _hdf5.File(zf.read("model.weights.h5")) as hf:
                yield (types.SimpleNamespace(attrs=attrs),
                       _V3Weights(hf, _v3_auto_paths(layer_cfgs)))
    else:
        with _hdf5.File(path) as f:
            yield f, (f["model_weights"] if "model_weights" in f else f)


def _h5_training_loss(f) -> Optional[str]:
    """The compiled loss from the h5 training_config attr, mapped to our
    loss name (reference enforceTrainingConfig path)."""
    raw = f.attrs.get("training_config")
    if raw is None:
        return None
    try:
        tc = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        loss = tc.get("loss")
        if isinstance(loss, dict):        # keras-3 serialized loss object
            loss = (loss.get("config", {}) or {}).get("name") \
                or loss.get("class_name")
        if isinstance(loss, str):
            key = loss.lower()
            # CamelCase class names -> snake ("CategoricalCrossentropy")
            key = re.sub(r"(?<!^)(?=[A-Z])", "_",
                         loss).lower() if loss != key else key
            return _KERAS_LOSSES.get(key)
    except Exception:   # noqa: BLE001 — absent/odd config = inference-only
        return None
    return None


def _model_config(f):
    raw = f.attrs["model_config"]
    return json.loads(raw.decode() if isinstance(raw, bytes) else raw)


def import_keras_sequential(path, input_shape=None, loss=None, device=None):
    """KerasModelImport.importKerasSequentialModelAndWeights analogue: a
    MultiLayerNetwork on ``device`` (None → CUDA).

    When the file carries a compiled loss (training_config) — or `loss=` is
    given — a trailing Dense becomes an OutputLayer with that loss, so the
    imported net is trainable with fit() (the reference's
    enforceTrainingConfig behavior). Without either, the import is
    inference-only like an uncompiled keras save.
    """
    from ..nn.layers.core import OutputLayer
    with _model_source(path) as (f, wg):
        cfg = _model_config(f)
        if cfg["class_name"] != "Sequential":
            raise ValueError("use import_keras_model for Functional models")
        layer_cfgs = cfg["config"]["layers"] \
            if isinstance(cfg["config"], dict) else cfg["config"]
        loss = loss or _h5_training_loss(f)
        b = NeuralNetConfiguration.builder().list()
        names = []
        itype = None
        mapped = []
        for kc in layer_cfgs:
            if itype is None:
                itype = _keras_input_type(kc)
            lyr = _map_layer(kc)
            if lyr is not None:
                mapped.append((lyr, kc["config"]["name"]))
        explicit_loss = loss is not None
        if loss is not None and mapped:
            # Dense + separate Activation('softmax'/...) is a common keras
            # ending: fold the activation into the converted OutputLayer
            if (len(mapped) >= 2 and isinstance(mapped[-1][0],
                                                ActivationLayer)
                    and type(mapped[-2][0]) is DenseLayer):
                act_layer, _ = mapped.pop()
                last, nm = mapped[-1]
                mapped[-1] = (OutputLayer(
                    n_out=last.n_out, activation=act_layer.activation,
                    has_bias=last.has_bias, loss=loss), nm)
            elif type(mapped[-1][0]) is DenseLayer:
                last, nm = mapped[-1]
                mapped[-1] = (OutputLayer(
                    n_out=last.n_out, activation=last.activation,
                    has_bias=last.has_bias, loss=loss), nm)
            elif explicit_loss:
                raise ValueError(
                    f"loss={loss!r} was requested but the model's last "
                    f"layer is {type(mapped[-1][0]).__name__}, not Dense — "
                    "cannot build a trainable OutputLayer head")
            else:
                import warnings
                warnings.warn(
                    "h5 carries a compiled loss but the final layer is "
                    f"{type(mapped[-1][0]).__name__}; importing "
                    "inference-only", stacklevel=2)
        for lyr, nm in mapped:
            b.layer(lyr)
            names.append(nm)
        if itype is not None:
            b.set_input_type(itype)
        net = MultiLayerNetwork(b.build())
        net.init(tuple(itype[1]) if itype else tuple(input_shape),
                 device=device)
        present = set(wg.keys())
        _assign_weights(net, wg, [n if n in present else None for n in names])
    return net


# ------------------------------------------------------------- functional --

def _inbound_names(kcfg) -> List[str]:
    """Input node names, handling BOTH the keras-2 nested-list format
    ([[['name', 0, 0, {}], ...]]) and the keras-3 __keras_tensor__ format."""
    out: List[str] = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("class_name") == "__keras_tensor__":
                out.append(o["config"]["keras_history"][0])
                return
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            if (len(o) >= 3 and isinstance(o[0], str)
                    and isinstance(o[1], int) and isinstance(o[2], int)):
                out.append(o[0])  # keras2 ['name', node_idx, tensor_idx, ...]
                return
            for v in o:
                walk(v)

    walk(kcfg.get("inbound_nodes", []))
    return out


def _io_names(spec) -> List[str]:
    """config['input_layers'] / ['output_layers'] → names. Either a single
    ['name', 0, 0] or a list of them."""
    if not spec:
        return []
    if isinstance(spec[0], str):
        return [spec[0]]
    return [s[0] for s in spec]


def import_keras_model(path, device=None):
    """KerasModelImport.importKerasModelAndWeights analogue: Functional
    keras model → ComputationGraph on ``device`` (None → CUDA)."""
    from ..nn.computation_graph import ComputationGraph

    with _model_source(path) as (f, wg):
        cfg = _model_config(f)
        if cfg["class_name"] == "Sequential":
            raise ValueError("use import_keras_sequential for Sequential "
                             "models")
        c = cfg["config"]
        inputs = _io_names(c["input_layers"])
        outputs = _io_names(c["output_layers"])
        b = NeuralNetConfiguration.builder().graph_builder()
        b.add_inputs(*inputs)
        input_shapes: Dict[str, tuple] = {}
        layer_names: Dict[str, Any] = {}  # graph node name → our layer
        for kc in c["layers"]:
            cls = kc["class_name"]
            name = kc["config"]["name"]
            if cls == "InputLayer":
                it = _keras_input_type(kc)
                if it is not None:
                    input_shapes[name] = tuple(it[1])
                continue
            inbound = _inbound_names(kc)
            if cls in _ELEMENTWISE:
                b.add_vertex(name, ElementWiseVertex(op=_ELEMENTWISE[cls]),
                             *inbound)
            elif cls == "Concatenate":
                b.add_vertex(name, MergeVertex(axis=kc["config"].get("axis",
                                                                     -1)),
                             *inbound)
            elif cls == "Flatten":
                b.add_vertex(name,
                             PreprocessorVertex(CnnToFeedForwardPreProcessor()),
                             *inbound)
            else:
                layer = _map_layer(kc)
                if layer is None:
                    raise NotImplementedError(
                        f"structural keras layer '{cls}' not supported in "
                        f"functional import")
                b.add_layer(name, layer, *inbound)
                layer_names[name] = layer
        b.set_outputs(*outputs)
        net = ComputationGraph(b.build())
        net.init([input_shapes[i] for i in inputs], device=device)
        present = set(wg.keys())
        for name in layer_names:
            if name not in present:
                continue
            ws = _weight_arrays(wg, name)
            if not ws:
                continue
            # the graph builder keeps its own copy of each layer
            _set_layer_weights(net.conf.nodes[name].op, net.params[name],
                               net.states[name], ws)
    return net
