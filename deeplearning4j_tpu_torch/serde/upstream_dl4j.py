"""Upstream-Deeplearning4j checkpoint interop — port of
``deeplearning4j_tpu/serde/upstream_dl4j.py``.

Reads and writes the zip layout every existing DL4J user holds
(reference: ``org.deeplearning4j.util.ModelSerializer.writeModel`` /
``restoreMultiLayerNetwork``, ``MultiLayerConfiguration.fromJson``):

    configuration.json   MultiLayerConfiguration JSON (Jackson @class-tagged)
    coefficients.bin     all params as ONE flat row vector, Nd4j.write wire
    updaterState.bin     optional flat updater state (Adam m/v)
    normalizer.bin       optional fitted normalizer

Wire layout of an Nd4j.write array (big-endian, java DataOutputStream):

    writeUTF(shape-buffer dtype name)        e.g. "LONG"
    writeInt(shapeInfo length)
    shapeInfo int64s: [rank, *shape, *stride, offset, elemWiseStride, order]
                      (order is the ascii code of 'c' or 'f')
    writeUTF(data dtype name)                "FLOAT" | "DOUBLE" | "HALF"
    writeInt(data length)
    raw big-endian values

Param packing (reference ``MultiLayerNetwork.params()``): layers in order;
per layer the initializer's param keys in order (Dense/Output/Embedding:
W, b; Convolution: W, b; BatchNormalization: gamma, beta, mean, var;
LSTM/GravesLSTM: W, RW, b); each tensor flattened in **'f' (column-major)
order** — DL4J allocates its param views in 'f' order. Conv kernels are
(nOut, nIn, kH, kW) upstream and HWIO (kH, kW, nIn, nOut) here —
transposed on the way through.

Restoring builds the net on ``device`` (None → CUDA) and copies the
arrays into its tensors. The Adam m/v of ``updaterState.bin`` wait in
``net._restored_opt_state`` (an :class:`UpstreamAdamState`) until ``fit``
builds the updater, which takes them into its ``mu``/``nu`` and ``count``
(``serde/model_serializer.py``'s ``restore_updater_``), as the JAX
package grafts them into optax's state.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from pathlib import Path

import numpy as np
import torch

_J = "org.deeplearning4j.nn.conf.layers."
_ACT = "org.nd4j.linalg.activations.impl."
_LOSS = "org.nd4j.linalg.lossfunctions.impl."
_UPD = "org.nd4j.linalg.learning.config."

# ------------------------------------------------------------------ nd4j wire

_DTYPES = {"FLOAT": (">f4", np.float32), "DOUBLE": (">f8", np.float64),
           "HALF": (">f2", np.float16), "LONG": (">i8", np.int64),
           "INT": (">i4", np.int32)}


def _read_utf(buf: io.BytesIO) -> str:
    (n,) = struct.unpack(">H", buf.read(2))
    return buf.read(n).decode("utf-8")


def _write_utf(buf: io.BytesIO, s: str):
    raw = s.encode("utf-8")
    buf.write(struct.pack(">H", len(raw)))
    buf.write(raw)


def read_nd4j_array(data) -> np.ndarray:
    """Parse one Nd4j.write()-format array from ``data`` (bytes, or a
    BytesIO stream — the stream is left positioned just past the frame,
    so back-to-back frames parse by repeated calls)."""
    buf = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    shape_dtype = _read_utf(buf)
    if shape_dtype not in ("LONG", "INT"):
        raise ValueError(f"unexpected shape-buffer dtype {shape_dtype!r}")
    (n_shape,) = struct.unpack(">i", buf.read(4))
    width = 8 if shape_dtype == "LONG" else 4
    fmt = ">%d%s" % (n_shape, "q" if shape_dtype == "LONG" else "i")
    info = struct.unpack(fmt, buf.read(width * n_shape))
    rank = int(info[0])
    shape = tuple(int(s) for s in info[1:1 + rank])
    order = chr(int(info[-1])) if info[-1] in (99, 102) else "c"
    data_dtype = _read_utf(buf)
    if data_dtype not in _DTYPES:
        raise ValueError(f"unsupported data dtype {data_dtype!r}")
    wire, host = _DTYPES[data_dtype]
    (n,) = struct.unpack(">i", buf.read(4))
    arr = np.frombuffer(buf.read(n * np.dtype(wire).itemsize), dtype=wire
                        ).astype(host)
    return arr.reshape(shape, order=order)


def write_nd4j_array(arr: np.ndarray, order: str = "c") -> bytes:
    """Serialize ``arr`` in the Nd4j.write() wire layout."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        name, wire = "DOUBLE", ">f8"
    elif arr.dtype == np.float16:
        name, wire = "HALF", ">f2"
    else:
        name, wire = "FLOAT", ">f4"
        arr = arr.astype(np.float32)
    rank = arr.ndim
    shape = arr.shape
    # strides in elements for the declared order
    strides = []
    acc = 1
    dims = shape if order == "f" else shape[::-1]
    for d in dims:
        strides.append(acc)
        acc *= d
    strides = strides if order == "f" else strides[::-1]
    info = [rank, *shape, *strides, 0, 1, ord(order)]
    buf = io.BytesIO()
    _write_utf(buf, "LONG")
    buf.write(struct.pack(">i", len(info)))
    buf.write(struct.pack(">%dq" % len(info), *info))
    _write_utf(buf, name)
    buf.write(struct.pack(">i", arr.size))
    buf.write(arr.ravel(order=order).astype(wire).tobytes())
    return buf.getvalue()


# ------------------------------------------------------------- config mapping

_ACT_FROM_JAVA = {
    "ActivationReLU": "relu", "ActivationReLU6": "relu6",
    "ActivationIdentity": "identity", "ActivationSoftmax": "softmax",
    "ActivationTanH": "tanh", "ActivationSigmoid": "sigmoid",
    "ActivationLReLU": "leakyrelu", "ActivationELU": "elu",
    "ActivationSELU": "selu", "ActivationGELU": "gelu",
    "ActivationSoftPlus": "softplus", "ActivationSoftSign": "softsign",
    "ActivationHardSigmoid": "hardsigmoid", "ActivationHardTanH": "hardtanh",
    "ActivationSwish": "swish", "ActivationMish": "mish",
    "ActivationCube": "cube", "ActivationRationalTanh": "rationaltanh",
    "ActivationRectifiedTanh": "rectifiedtanh",
}
_ACT_TO_JAVA = {v: k for k, v in _ACT_FROM_JAVA.items()}

_LOSS_FROM_JAVA = {
    "LossMCXENT": "mcxent", "LossNegativeLogLikelihood": "mcxent",
    "LossMSE": "mse", "LossL2": "l2", "LossL1": "l1", "LossMAE": "mae",
    "LossBinaryXENT": "binary_xent", "LossHinge": "hinge",
    "LossSquaredHinge": "squared_hinge", "LossKLD": "kld",
    "LossPoisson": "poisson", "LossCosineProximity": "cosine_proximity",
    "LossMSLE": "msle", "LossMAPE": "mape",
}
_LOSS_TO_JAVA = {
    "mcxent": "LossMCXENT", "mse": "LossMSE", "l2": "LossL2", "l1": "LossL1",
    "mae": "LossMAE", "binary_xent": "LossBinaryXENT", "hinge": "LossHinge",
    "squared_hinge": "LossSquaredHinge", "kld": "LossKLD",
    "poisson": "LossPoisson", "cosine_proximity": "LossCosineProximity",
    "msle": "LossMSLE", "mape": "LossMAPE",
}


def _act_from_json(d):
    if d is None:
        return None
    if isinstance(d, str):
        return d.lower()
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    if cls not in _ACT_FROM_JAVA:
        raise ValueError(f"unsupported upstream activation {cls!r}")
    return _ACT_FROM_JAVA[cls]


def _updater_from_json(d):
    from ..train import updaters as U
    if d is None:
        return None
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    lr = d.get("learningRate", 1e-3)
    table = {
        "Adam": lambda: U.Adam(lr, beta1=d.get("beta1", 0.9),
                               beta2=d.get("beta2", 0.999),
                               epsilon=d.get("epsilon", 1e-8)),
        "AdamW": lambda: U.AdamW(lr, beta1=d.get("beta1", 0.9),
                                 beta2=d.get("beta2", 0.999),
                                 epsilon=d.get("epsilon", 1e-8),
                                 weight_decay=d.get("weightDecay", 1e-2)),
        "Sgd": lambda: U.Sgd(lr),
        "Nesterovs": lambda: U.Nesterovs(lr, momentum=d.get("momentum", 0.9)),
        "RmsProp": lambda: U.RmsProp(lr, epsilon=d.get("epsilon", 1e-8)),
        "AdaGrad": lambda: U.AdaGrad(lr, epsilon=d.get("epsilon", 1e-6)),
        "AdaDelta": lambda: U.AdaDelta(),
        "Nadam": lambda: U.Nadam(lr),
        "AMSGrad": lambda: U.AMSGrad(lr),
        "AdaMax": lambda: U.AdaMax(lr),
        "NoOp": lambda: U.NoOp(),
    }
    if cls not in table:
        raise ValueError(f"unsupported upstream updater {cls!r}")
    return table[cls]()


def _updater_to_json(u):
    name = type(u).__name__
    d = {"@class": _UPD + name}
    if hasattr(u, "learning_rate"):
        lr = u.learning_rate
        if hasattr(lr, "value_at"):
            try:
                lr = lr.value_at(0, 0)   # schedule: export its step-0 value
            except Exception as e:  # noqa: BLE001
                raise ValueError(
                    f"learning-rate schedule {type(u.learning_rate).__name__}"
                    " cannot be exported to the upstream format (could not "
                    f"evaluate it at step 0: {e}); set a scalar lr before "
                    "exporting") from e
        d["learningRate"] = float(lr)
    for ours, theirs in (("beta1", "beta1"), ("beta2", "beta2"),
                         ("epsilon", "epsilon"), ("momentum", "momentum"),
                         ("weight_decay", "weightDecay")):
        if hasattr(u, ours):
            d[theirs] = float(getattr(u, ours))
    return d


def _layer_from_json(d):
    """One upstream layer JSON dict → our Layer dataclass."""
    from ..nn.layers import conv as C
    from ..nn.layers import core as K
    from ..nn.layers import norm as N
    from ..nn.layers import recurrent as R

    cls = d.get("@class", "").rsplit(".", 1)[-1]
    act = _act_from_json(d.get("activationFn") or d.get("activation"))
    common = {}
    if act is not None:
        common["activation"] = act

    if cls in ("DenseLayer",):
        return K.DenseLayer(n_in=int(d["nin"]), n_out=int(d["nout"]),
                            has_bias=d.get("hasBias", True), **common)
    if cls in ("OutputLayer", "RnnOutputLayer"):
        loss = d.get("lossFn") or d.get("lossFunction")
        if isinstance(loss, dict):
            lname = loss.get("@class", "").rsplit(".", 1)[-1]
            if lname not in _LOSS_FROM_JAVA:
                raise ValueError(f"unsupported upstream loss {lname!r}")
            loss = _LOSS_FROM_JAVA[lname]
        elif isinstance(loss, str):
            loss = loss.lower()
        else:
            loss = "mcxent"
        klass = K.RnnOutputLayer if cls == "RnnOutputLayer" else K.OutputLayer
        return klass(n_in=int(d["nin"]), n_out=int(d["nout"]), loss=loss,
                     has_bias=d.get("hasBias", True),
                     **(common or {"activation": "softmax"}))
    if cls == "ConvolutionLayer":
        return C.ConvolutionLayer(
            n_in=int(d["nin"]), n_out=int(d["nout"]),
            kernel_size=tuple(d.get("kernelSize", (3, 3))),
            stride=tuple(d.get("stride", (1, 1))),
            padding=tuple(d.get("padding", (0, 0))),
            dilation=tuple(d.get("dilation", (1, 1))),
            convolution_mode=d.get("convolutionMode", "Truncate").lower(),
            has_bias=d.get("hasBias", True), **common)
    if cls == "SubsamplingLayer":
        pt = d.get("poolingType", "MAX")
        pt = pt if isinstance(pt, str) else pt.get("poolingType", "MAX")
        return C.SubsamplingLayer(
            kernel_size=tuple(d.get("kernelSize", (2, 2))),
            stride=tuple(d.get("stride") or d.get("kernelSize", (2, 2))),
            padding=tuple(d.get("padding", (0, 0))),
            convolution_mode=d.get("convolutionMode", "Truncate").lower(),
            pooling_type=pt.lower())
    if cls == "BatchNormalization":
        return N.BatchNormalization(decay=d.get("decay", 0.9),
                                    eps=d.get("eps", 1e-5),
                                    **common)
    if cls in ("LSTM", "GravesLSTM"):
        klass = R.GravesLSTM if cls == "GravesLSTM" else R.LSTM
        gate = _act_from_json(d.get("gateActivationFn")) or "sigmoid"
        return klass(n_in=int(d["nin"]), n_out=int(d["nout"]),
                     forget_gate_bias=d.get("forgetGateBiasInit", 1.0),
                     gate_activation=gate,
                     **(common or {"activation": "tanh"}))
    if cls == "EmbeddingLayer":
        return K.EmbeddingLayer(n_in=int(d["nin"]), n_out=int(d["nout"]),
                                has_bias=d.get("hasBias", False), **common)
    if cls == "ActivationLayer":
        return K.ActivationLayer(**(common or {"activation": "identity"}))
    if cls == "DropoutLayer":
        rate = 1.0 - d.get("idropout", {}).get("p", 0.5) \
            if isinstance(d.get("idropout"), dict) else d.get("dropout", 0.5)
        return K.DropoutLayer(rate=rate)
    raise ValueError(
        f"unsupported upstream layer class {cls!r} — supported: Dense, "
        "Output, RnnOutput, Convolution, Subsampling, BatchNormalization, "
        "LSTM, GravesLSTM, Embedding, Activation, Dropout")


def _layer_to_json(layer):
    from ..nn.layers import conv as C
    from ..nn.layers import core as K
    from ..nn.layers import norm as N
    from ..nn.layers import recurrent as R
    from ..nn.layers.wrappers import unwrap

    lyr = unwrap(layer)
    raw_act = getattr(lyr, "activation", None)
    if raw_act is not None and not isinstance(raw_act, str):
        raise ValueError(
            f"layer {type(lyr).__name__} uses a callable activation "
            f"{raw_act!r} — only named activations can be exported to the "
            "upstream format")
    act_name = raw_act

    def act_json(name):
        if name not in _ACT_TO_JAVA:
            raise ValueError(f"activation {name!r} has no upstream analogue")
        return {"@class": _ACT + _ACT_TO_JAVA[name]}

    if isinstance(lyr, K.RnnOutputLayer) or (type(lyr) is K.OutputLayer):
        loss = str(lyr.loss).lower()
        if loss not in _LOSS_TO_JAVA:
            raise ValueError(f"loss {loss!r} has no upstream analogue")
        cls = "RnnOutputLayer" if isinstance(lyr, K.RnnOutputLayer) \
            else "OutputLayer"
        return {"@class": _J + cls, "nin": int(lyr.n_in), "nout": int(lyr.n_out),
                "hasBias": bool(lyr.has_bias),
                "activationFn": act_json(act_name or "softmax"),
                "lossFn": {"@class": _LOSS + _LOSS_TO_JAVA[loss]}}
    if type(lyr) is K.DenseLayer:
        return {"@class": _J + "DenseLayer", "nin": int(lyr.n_in),
                "nout": int(lyr.n_out), "hasBias": bool(lyr.has_bias),
                "activationFn": act_json(act_name or "identity")}
    if type(lyr) is C.ConvolutionLayer:
        return {"@class": _J + "ConvolutionLayer", "nin": int(lyr.n_in),
                "nout": int(lyr.n_out),
                "kernelSize": list(_pair(lyr.kernel_size)),
                "stride": list(_pair(lyr.stride)),
                "padding": list(_pair(lyr.padding)),
                "dilation": list(_pair(lyr.dilation)),
                "convolutionMode": lyr.convolution_mode.capitalize(),
                "hasBias": bool(lyr.has_bias),
                "activationFn": act_json(act_name or "identity")}
    if type(lyr) is C.SubsamplingLayer:
        return {"@class": _J + "SubsamplingLayer",
                "kernelSize": list(_pair(lyr.kernel_size)),
                "stride": list(_pair(lyr.stride or lyr.kernel_size)),
                "padding": list(_pair(lyr.padding)),
                "convolutionMode": lyr.convolution_mode.capitalize(),
                "poolingType": lyr.pooling_type.upper()}
    if type(lyr) is N.BatchNormalization:
        return {"@class": _J + "BatchNormalization",
                "decay": float(lyr.decay), "eps": float(lyr.eps),
                "activationFn": act_json(act_name or "identity")}
    if isinstance(lyr, R.LSTM):
        cls = "GravesLSTM" if isinstance(lyr, R.GravesLSTM) else "LSTM"
        return {"@class": _J + cls, "nin": int(lyr.n_in),
                "nout": int(lyr.n_out),
                "forgetGateBiasInit": float(lyr.forget_gate_bias),
                "activationFn": act_json(act_name or "tanh"),
                "gateActivationFn": act_json(lyr.gate_activation)}
    if type(lyr) is K.EmbeddingLayer:
        return {"@class": _J + "EmbeddingLayer", "nin": int(lyr.n_in),
                "nout": int(lyr.n_out), "hasBias": bool(lyr.has_bias),
                "activationFn": act_json(act_name or "identity")}
    if type(lyr) is K.ActivationLayer:
        return {"@class": _J + "ActivationLayer",
                "activationFn": act_json(act_name or "identity")}
    if type(lyr) is K.DropoutLayer:
        return {"@class": _J + "DropoutLayer",
                "idropout": {"@class": "org.deeplearning4j.nn.conf.dropout."
                                       "Dropout", "p": 1.0 - lyr.rate}}
    raise ValueError(f"layer {type(lyr).__name__} has no upstream-format "
                     "writer (supported: Dense/Output/RnnOutput/Conv/"
                     "Subsampling/BatchNorm/LSTM/GravesLSTM/Embedding/"
                     "Activation/Dropout)")


def _pair(v):
    if v is None:
        return (1, 1)
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


# ------------------------------------------------------------- param packing

def _np(t):
    """A host numpy copy of a tensor (bf16 widened to f32) or an array."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _upstream_param_entries(layer, params, state):
    """[(key, upstream_np_array)] for one layer, upstream order + layout."""
    from ..nn.layers import conv as C
    from ..nn.layers import norm as N
    from ..nn.layers.wrappers import unwrap

    lyr = unwrap(layer)
    out = []
    if isinstance(lyr, N.BatchNormalization):
        c = state["mean"].shape[0]
        gamma = params.get("gamma", np.ones((c,), np.float32))
        beta = params.get("beta", np.zeros((c,), np.float32))
        return [("gamma", _np(gamma)), ("beta", _np(beta)),
                ("mean", _np(state["mean"])), ("var", _np(state["var"]))]
    if isinstance(lyr, C.ConvolutionLayer) and "W" in params:
        w = _np(params["W"]).transpose(3, 2, 0, 1)  # HWIO → OIHW
        out.append(("W", w))
        if "b" in params:
            out.append(("b", _np(params["b"])))
        return out
    for key in ("W", "RW", "b", "pI", "pF", "pO"):
        if key in params:
            out.append((key, _np(params[key])))
    for key in sorted(params):
        if key not in dict(out):
            out.append((key, _np(params[key])))
    return out


def _iter_param_nodes(net):
    """(key, layer, params, states) per param-bearing node, packing order:
    MLN = layer index order; CG = topological node order."""
    if hasattr(net, "layers"):                         # MultiLayerNetwork
        for i, layer in enumerate(net.layers):
            yield (f"layer_{i}", layer, net.params[f"layer_{i}"],
                   net.states[f"layer_{i}"])
    else:                                              # ComputationGraph
        from ..nn.layers.base import Layer
        for name in net.conf.topo_order:
            op = net.conf.nodes[name].op
            if isinstance(op, Layer):
                yield (name, op, net.params.get(name, {}),
                       net.states.get(name, {}))


def _copy(tree, key, arr):
    """``arr`` into the net's tensor ``tree[key]``, in place."""
    t = tree[key]
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))


def _assign_upstream_params(net, flat: np.ndarray):
    """Split the upstream flat row vector back into net.params/states, in
    place (MLN and CG — _iter_param_nodes fixes the packing order)."""
    from ..nn.layers import conv as C
    from ..nn.layers import norm as N
    from ..nn.layers.wrappers import unwrap

    flat = np.asarray(flat).reshape(-1)
    off = 0

    def take(shape):
        nonlocal off
        n = int(np.prod(shape))
        if off + n > flat.size:
            raise ValueError(
                f"coefficients.bin too short: need {off + n} floats, "
                f"have {flat.size}")
        chunk = flat[off:off + n].reshape(shape, order="f")
        off += n
        return chunk

    for _key, layer, p, s in _iter_param_nodes(net):
        lyr = unwrap(layer)
        if isinstance(lyr, N.BatchNormalization):
            c = s["mean"].shape[0]
            gamma = take((c,))
            beta = take((c,))
            mean = take((c,))
            var = take((c,))
            if "gamma" in p:
                _copy(p, "gamma", gamma)
                _copy(p, "beta", beta)
            _copy(s, "mean", mean)
            _copy(s, "var", var)
            continue
        if isinstance(lyr, C.ConvolutionLayer) and "W" in p:
            kh, kw, cin, cout = p["W"].shape
            w = take((cout, cin, kh, kw)).transpose(2, 3, 1, 0)  # OIHW → HWIO
            _copy(p, "W", w)
            if "b" in p:
                _copy(p, "b", take(tuple(p["b"].shape)))
            continue
        keys = [k for k in ("W", "RW", "b", "pI", "pF", "pO") if k in p]
        keys += [k for k in sorted(p) if k not in keys]
        for k in keys:
            _copy(p, k, take(tuple(p[k].shape)))
    if off != flat.size:
        raise ValueError(f"coefficients.bin has {flat.size} floats but the "
                         f"configuration consumes {off} — config/params "
                         "mismatch")


def _param_order_arrays(net):
    """All upstream param entries of the whole net, packing order."""
    out = []
    for _key, layer, p, s in _iter_param_nodes(net):
        out.extend(a for _, a in _upstream_param_entries(layer, p, s))
    return out


# ------------------------------------------------------------------ zip io

_IT = "org.deeplearning4j.nn.conf.inputs.InputType$"


def _shape_to_input_type_json(shape):
    """A concrete input shape → the upstream InputType JSON (rank decides:
    4=cnn3d DHWC, 3=cnn HWC, 2=recurrent (T, C), 1=feed-forward)."""
    shape = tuple(shape)
    if len(shape) == 4:
        dd, h, w, c = shape
        return {"@class": _IT + "InputTypeConvolutional3D",
                "depth": int(dd), "height": int(h), "width": int(w),
                "channels": int(c)}
    if len(shape) == 3:
        h, w, c = shape
        return {"@class": _IT + "InputTypeConvolutional",
                "height": int(h), "width": int(w), "channels": int(c)}
    if len(shape) == 2:
        t, c = shape
        d = {"@class": _IT + "InputTypeRecurrent", "size": int(c)}
        if t is not None:
            d["timeSeriesLength"] = int(t)
        return d
    return {"@class": _IT + "InputTypeFeedForward", "size": int(shape[-1])}


def _input_type_json(net):
    shape = getattr(net, "_init_input_shape", None)
    return None if shape is None else _shape_to_input_type_json(shape)


def _input_type_from_json(it):
    """Upstream InputType JSON → our (kind, shape) input-type tuple."""
    cls = it.get("@class", "").rsplit("$", 1)[-1]
    if cls == "InputTypeConvolutional3D":
        return ("cnn3d", (int(it["depth"]), int(it["height"]),
                          int(it["width"]), int(it["channels"])))
    if cls == "InputTypeConvolutional":
        return ("cnn", (int(it["height"]), int(it["width"]),
                        int(it["channels"])))
    if cls == "InputTypeRecurrent":
        t = it.get("timeSeriesLength")
        return ("rnn", (int(t) if t else None, int(it["size"])))
    if cls == "InputTypeFeedForward":
        return ("ff", (int(it["size"]),))
    raise ValueError(f"unsupported upstream InputType {cls!r}")


def _input_shape_from_json(d, layers):
    it = d.get("inputType")
    if it:
        return _input_type_from_json(it)[1]
    n_in = getattr(layers[0], "n_in", None)
    if n_in:
        # recurrent first layer needs (T, C); feed-forward needs (C,)
        from ..nn.layers.recurrent import BaseRecurrent
        if isinstance(layers[0], BaseRecurrent):
            return (None, int(n_in))
        return (int(n_in),)
    raise ValueError("configuration.json has no inputType and the first "
                     "layer has no nIn — cannot infer input shape")


def write_model_upstream_format(net, path, save_updater: bool = False,
                                normalizer=None):
    """Write ``net`` in the upstream DL4J zip layout (configuration.json +
    coefficients.bin [+ updaterState.bin] [+ normalizer.bin]).
    ComputationGraph nets route to the CG writer automatically."""
    if not hasattr(net, "layers"):          # a ComputationGraph
        return write_computation_graph_upstream_format(
            net, path, save_updater=save_updater, normalizer=normalizer)
    top = json.loads(mln_conf_to_upstream_json(net.conf))
    top["iterationCount"] = int(getattr(net, "_step_count", 0))
    it = _input_type_json(net)   # net's resolved init shape beats the
    if it:                       # config-level declaration when present
        top["inputType"] = it
    arrays = _param_order_arrays(net)
    flat = np.concatenate([a.ravel(order="f").astype(np.float32)
                           for a in arrays]) if arrays else np.zeros(0, "f4")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(top, indent=2))
        zf.writestr("coefficients.bin",
                    write_nd4j_array(flat.reshape(1, -1), order="f"))
        if save_updater and getattr(net, "_opt_state", None) is not None:
            m, v = _extract_adam_mv(net)
            if m is not None:
                state = np.concatenate([
                    np.concatenate([mm.ravel(order="f"), vv.ravel(order="f")])
                    for mm, vv in zip(m, v)]) if m else np.zeros(0, "f4")
                zf.writestr("updaterState.bin",
                            write_nd4j_array(
                                state.astype(np.float32).reshape(1, -1),
                                order="f"))
        norm = normalizer or getattr(net, "normalizer", None)
        if norm is not None:
            zf.writestr("normalizer.bin",
                        write_normalizer_upstream_format(norm))


def _adam_states(state):
    """The adam-style parts (dicts with ``mu`` and ``nu``) of the port's
    updater state: chains are tuples, ``multi_transform`` a dict by label."""
    if isinstance(state, dict):
        if "mu" in state and "nu" in state:
            return [state]
        return [s for v in state.values() for s in _adam_states(v)]
    if isinstance(state, (tuple, list)):
        return [s for v in state for s in _adam_states(v)]
    return []


def _extract_adam_mv(net):
    """Per-upstream-param [m], [v] lists from the updater state, or (None,
    None) when the optimizer has no adam-style mu/nu."""
    found = _adam_states(net._opt_state)
    if not found:
        return None, None
    mu, nu = found[0]["mu"], found[0]["nu"]
    ms, vs = [], []
    for nkey, layer, p, s in _iter_param_nodes(net):
        entries = _upstream_param_entries(layer, p, s)
        mu_i = mu.get(nkey, {})
        nu_i = nu.get(nkey, {})
        for key, arr in entries:
            if key in ("mean", "var", "gamma", "beta"):
                src_m = mu_i.get(key) if key in ("gamma", "beta") else None
                src_v = nu_i.get(key) if key in ("gamma", "beta") else None
                if src_m is None:
                    if key in ("mean", "var"):
                        continue       # BN running stats carry no updater state
                    src_m = np.zeros_like(arr)
                    src_v = np.zeros_like(arr)
            else:
                src_m = mu_i.get(key, np.zeros_like(arr))
                src_v = nu_i.get(key, np.zeros_like(arr))
            from ..nn.layers import conv as C
            from ..nn.layers.wrappers import unwrap
            if isinstance(unwrap(layer), C.ConvolutionLayer) and key == "W":
                src_m = _np(src_m).transpose(3, 2, 0, 1)
                src_v = _np(src_v).transpose(3, 2, 0, 1)
            ms.append(_np(src_m))
            vs.append(_np(src_v))
    return ms, vs


class UpstreamAdamState:
    """Adam m/v trees (numpy, shaped like the net's params) and the step
    count read from an ``updaterState.bin``, waiting for ``fit`` to build
    the updater (``restore_updater_`` grafts them in)."""

    def __init__(self, mu, nu, count):
        self.mu, self.nu, self.count = mu, nu, count


def _adopt_updater_state(net, flat: np.ndarray, iteration_count: int = 0):
    """Map an upstream flat Adam state ([m, v] per param, packing order)
    onto ``net._restored_opt_state`` = UpstreamAdamState(mu_tree, nu_tree,
    count), which the updater takes when ``fit`` builds it."""
    from ..nn.layers import conv as C
    from ..nn.layers.wrappers import unwrap

    flat = np.asarray(flat).reshape(-1)
    # the mu/nu trees must MATCH net.params' structure (the graft walks
    # them), so start every node key — param-less vertex nodes included —
    # with an empty dict
    mu = {k: {} for k in net.params}
    nu = {k: {} for k in net.params}
    off = 0
    for nkey, layer, p, s in _iter_param_nodes(net):
        lyr = unwrap(layer)
        entries = _upstream_param_entries(layer, p, s)
        mu_i, nu_i = {}, {}
        for key, arr in entries:
            if key in ("mean", "var"):
                continue
            n = arr.size
            if off + 2 * n > flat.size:
                raise ValueError("updaterState.bin too short for the "
                                 "configuration's parameters")
            m = flat[off:off + n].reshape(arr.shape, order="f")
            v = flat[off + n:off + 2 * n].reshape(arr.shape, order="f")
            off += 2 * n
            if key not in p:
                continue               # e.g. locked BN gamma/beta
            if isinstance(lyr, C.ConvolutionLayer) and key == "W":
                m = m.transpose(2, 3, 1, 0)
                v = v.transpose(2, 3, 1, 0)
            mu_i[key] = np.asarray(m, np.float32)
            nu_i[key] = np.asarray(v, np.float32)
        mu[nkey] = mu_i
        nu[nkey] = nu_i
    if off != flat.size:
        raise ValueError(f"updaterState.bin has {flat.size} floats; the "
                         f"configuration consumes {off}")
    state = UpstreamAdamState(mu, nu, int(iteration_count))
    if net._opt_state is None:
        net._restored_opt_state = state
    else:
        graft_adam_state(net._opt_state, state)


def graft_adam_state(opt_state, upstream: UpstreamAdamState):
    """Copy the restored mu/nu trees and count into every adam-style part
    of the port's updater state, in place (the tensors a captured step
    reads stay the same)."""
    def put(old, new, path):
        if isinstance(old, dict):
            for k in old:
                if k not in new:
                    raise KeyError(f"updaterState.bin has no state for "
                                   f"{path}{k}")
                put(old[k], new[k], f"{path}{k}|")
            return
        src = torch.from_numpy(np.ascontiguousarray(new))
        if tuple(src.shape) != tuple(old.shape):
            raise ValueError(f"updater state {path[:-1]}: shape "
                             f"{tuple(src.shape)}, the net's "
                             f"{tuple(old.shape)}")
        old.copy_(src.to(old.dtype))

    with torch.no_grad():
        for part in _adam_states(opt_state):
            put(part["mu"], upstream.mu, "")
            put(part["nu"], upstream.nu, "")
            part["count"].fill_(int(upstream.count))
    return opt_state


def restore_upstream_multi_layer_network(path, load_updater: bool = True,
                                         device=None):
    """Restore an upstream-format DL4J zip as our MultiLayerNetwork, on
    ``device`` (None → CUDA)."""
    from ..nn.multi_layer_network import MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        if "configuration.json" not in names:
            raise ValueError(f"{path} is not an upstream-format DL4J zip "
                             "(no configuration.json)")
        conf_json = json.loads(zf.read("configuration.json"))
        if "confs" not in conf_json:
            if "vertices" in conf_json or "networkInputs" in conf_json:
                raise ValueError(
                    "this is an upstream ComputationGraph zip — use "
                    "restore_upstream_computation_graph (or the "
                    "ModelSerializer facade, which auto-routes)")
            raise ValueError("configuration.json has no 'confs' — not an "
                             "upstream MultiLayerConfiguration")
        if "coefficients.bin" not in names:
            raise ValueError(f"{path} has configuration.json but no "
                             "coefficients.bin — not a complete upstream "
                             "DL4J model zip")
        conf = mln_conf_from_upstream_json(conf_json)
        upd = conf.globals_.updater
        net = MultiLayerNetwork(conf)
        net.init(_input_shape_from_json(conf_json, conf.layers),
                 device=device)
        flat = read_nd4j_array(zf.read("coefficients.bin"))
        _assign_upstream_params(net, flat)
        net._step_count = int(conf_json.get("iterationCount", 0))
        if load_updater and "updaterState.bin" in names:
            from ..train import updaters as U
            if isinstance(upd, (U.Adam, U.AdamW)):
                _adopt_updater_state(
                    net, read_nd4j_array(zf.read("updaterState.bin")),
                    conf_json.get("iterationCount", 0))
            else:
                import warnings
                warnings.warn(
                    f"updaterState.bin present but the updater is "
                    f"{type(upd).__name__} — only Adam/AdamW state layouts "
                    "(2 floats per param) are mapped; training resumes "
                    "with fresh optimizer state", stacklevel=2)
        if "normalizer.bin" in names:
            net.normalizer = read_normalizer_upstream_format(
                zf.read("normalizer.bin"))
    return net


def is_upstream_format(path) -> bool:
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        return "configuration.json" in names and "coefficients.bin" in names
    except (zipfile.BadZipFile, OSError):
        return False


# -------------------------------------------------- ComputationGraph zips --
# Upstream ComputationGraphConfiguration JSON: networkInputs/networkOutputs,
# "vertices" (@class-tagged GraphVertex configs; LayerVertex wraps a
# NeuralNetConfiguration holding the layer), "vertexInputs". Param packing
# follows the graph's topological order (reference ComputationGraph.params()
# flattens vertex param tables in topo order); our writer emits "vertices"
# in that same order so the round trip is stable, and for foreign JSON the
# packing order is the builder's (deterministic) Kahn sort, the JAX
# package's order too.

_GV = "org.deeplearning4j.nn.conf.graph."
_EW_FROM_JAVA = {"Add": "add", "Subtract": "sub", "Product": "mul",
                 "Average": "avg", "Max": "max"}
_EW_TO_JAVA = {v: k for k, v in _EW_FROM_JAVA.items()}


def _vertex_from_json(d):
    from ..nn import vertices as V
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    if cls == "MergeVertex":
        return V.MergeVertex(axis=int(d.get("mergeAxis", -1)))
    if cls == "ElementWiseVertex":
        op = d.get("op", "Add")
        if op not in _EW_FROM_JAVA:
            raise ValueError(f"unsupported ElementWiseVertex op {op!r}")
        return V.ElementWiseVertex(op=_EW_FROM_JAVA[op])
    if cls == "ScaleVertex":
        return V.ScaleVertex(scale=float(d.get("scaleFactor", 1.0)))
    if cls == "ShiftVertex":
        return V.ShiftVertex(shift=float(d.get("shiftFactor", 0.0)))
    if cls == "L2NormalizeVertex":
        kw = {}
        if "eps" in d:
            kw["eps"] = float(d["eps"])
        return V.L2NormalizeVertex(**kw)
    if cls == "StackVertex":
        return V.StackVertex()
    if cls == "SubsetVertex":
        return V.SubsetVertex(lo=int(d["from"]), hi=int(d["to"]))
    raise ValueError(
        f"unsupported upstream graph vertex {cls!r} — supported: "
        "LayerVertex, Merge, ElementWise, Scale, Shift, L2Normalize, "
        "Stack, Subset")


def _vertex_to_json(v):
    from ..nn import vertices as V
    if type(v) is V.MergeVertex:
        return {"@class": _GV + "MergeVertex", "mergeAxis": int(v.axis)}
    if type(v) is V.ElementWiseVertex:
        if v.op not in _EW_TO_JAVA:
            raise ValueError(f"ElementWiseVertex op {v.op!r} has no "
                             "upstream analogue")
        return {"@class": _GV + "ElementWiseVertex", "op": _EW_TO_JAVA[v.op]}
    if type(v) is V.ScaleVertex:
        return {"@class": _GV + "ScaleVertex", "scaleFactor": float(v.scale)}
    if type(v) is V.ShiftVertex:
        return {"@class": _GV + "ShiftVertex", "shiftFactor": float(v.shift)}
    if type(v) is V.L2NormalizeVertex:
        return {"@class": _GV + "L2NormalizeVertex", "eps": float(v.eps)}
    if type(v) is V.StackVertex:
        return {"@class": _GV + "StackVertex"}
    if type(v) is V.SubsetVertex:
        return {"@class": _GV + "SubsetVertex", "from": int(v.lo),
                "to": int(v.hi)}
    raise ValueError(f"vertex {type(v).__name__} has no upstream-format "
                     "writer")


def write_computation_graph_upstream_format(cg, path,
                                            save_updater: bool = False,
                                            normalizer=None):
    """Write a ComputationGraph in the upstream DL4J zip layout."""
    top = json.loads(cg_conf_to_upstream_json(cg.conf))
    top["iterationCount"] = int(getattr(cg, "_step_count", 0))
    # convenience duplicate of the per-LayerVertex iUpdater
    top["iUpdater"] = _updater_to_json(cg.conf.globals_.updater)
    shapes = getattr(cg, "_init_shapes", None)
    if shapes:   # the net's resolved init shapes beat any config-level
        top["inputTypes"] = [_shape_to_input_type_json(s) for s in shapes]
    arrays = _param_order_arrays(cg)
    flat = np.concatenate([a.ravel(order="f").astype(np.float32)
                           for a in arrays]) if arrays else np.zeros(0, "f4")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(top, indent=2))
        zf.writestr("coefficients.bin",
                    write_nd4j_array(flat.reshape(1, -1), order="f"))
        if save_updater and getattr(cg, "_opt_state", None) is not None:
            m, v = _extract_adam_mv(cg)
            if m is not None:
                state = np.concatenate([
                    np.concatenate([mm.ravel(order="f"), vv.ravel(order="f")])
                    for mm, vv in zip(m, v)]) if m else np.zeros(0, "f4")
                zf.writestr("updaterState.bin",
                            write_nd4j_array(
                                state.astype(np.float32).reshape(1, -1),
                                order="f"))
        norm = normalizer or getattr(cg, "normalizer", None)
        if norm is not None:
            zf.writestr("normalizer.bin",
                        write_normalizer_upstream_format(norm))


def restore_upstream_computation_graph(path, input_shapes=None,
                                       load_updater: bool = True,
                                       device=None):
    """Restore an upstream-format ComputationGraph zip, on ``device``
    (None → CUDA)."""
    from ..nn.computation_graph import ComputationGraph

    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        conf_json = json.loads(zf.read("configuration.json"))
        if "vertices" not in conf_json:
            raise ValueError("configuration.json has no 'vertices' — use "
                             "restore_upstream_multi_layer_network for "
                             "MultiLayerNetwork zips")
        if "coefficients.bin" not in names:
            raise ValueError(f"{path} has configuration.json but no "
                             "coefficients.bin — not a complete upstream "
                             "DL4J model zip")
        gconf = cg_conf_from_upstream_json(conf_json)
        upd = gconf.globals_.updater
        cg = ComputationGraph(gconf)
        if input_shapes is None:
            if gconf.input_types:
                input_shapes = [tuple(t[1]) for t in gconf.input_types]
            else:
                raise ValueError(
                    "configuration.json has no inputTypes — pass "
                    "input_shapes=[...] to restore_upstream_computation_graph")
        cg.init(list(input_shapes), device=device)

        flat = read_nd4j_array(zf.read("coefficients.bin"))
        _assign_upstream_params(cg, flat)   # shared MLN/CG unpacker
        cg._step_count = int(conf_json.get("iterationCount", 0))
        if load_updater and "updaterState.bin" in names:
            from ..train import updaters as U
            if isinstance(upd, (U.Adam, U.AdamW)):
                _adopt_updater_state(
                    cg, read_nd4j_array(zf.read("updaterState.bin")),
                    conf_json.get("iterationCount", 0))
            else:
                import warnings
                warnings.warn(
                    f"updaterState.bin present but the updater is "
                    f"{type(upd).__name__} — only Adam/AdamW state layouts "
                    "are mapped; training resumes with fresh optimizer "
                    "state", stacklevel=2)
        if "normalizer.bin" in names:
            cg.normalizer = read_normalizer_upstream_format(
                zf.read("normalizer.bin"))
    return cg


# ----------------------------------------------------------- normalizer.bin
# Reference: ``NormalizerSerializer`` — ModelSerializer.addNormalizerToModel
# stores the fitted normalizer as a "normalizer.bin" zip entry. Wire spec
# (strategies beyond standardize/min-max are rejected loudly):
#   writeUTF(strategy)        "STANDARDIZE" | "MIN_MAX"
#   writeBoolean(fitLabels)   1 byte
#   MIN_MAX only: float64 targetMin, float64 targetMax (big-endian)
#   Nd4j arrays: feature stats pair [, label stats pair when fitLabels]
#     STANDARDIZE: mean, std      MIN_MAX: min, max


def _stats_from_mean_std(mean, std):
    from ..data.normalizers import _Stats
    st = _Stats()
    mean = np.asarray(mean, np.float64).reshape(-1)
    std = np.asarray(std, np.float64).reshape(-1)
    st.n = 1
    st.sum = mean.copy()
    st.sum_sq = std * std + mean * mean   # var = sum_sq/n − mean²
    st.min = mean - std
    st.max = mean + std
    return st


def _stats_from_min_max(mn, mx):
    from ..data.normalizers import _Stats
    st = _Stats()
    mn = np.asarray(mn, np.float64).reshape(-1)
    mx = np.asarray(mx, np.float64).reshape(-1)
    st.n = 1
    st.sum = (mn + mx) / 2
    st.sum_sq = st.sum * st.sum
    st.min = mn
    st.max = mx
    return st


def write_normalizer_upstream_format(norm) -> bytes:
    from ..data.normalizers import (NormalizerMinMaxScaler,
                                    NormalizerStandardize)
    buf = io.BytesIO()
    if isinstance(norm, NormalizerStandardize):
        _write_utf(buf, "STANDARDIZE")
        buf.write(struct.pack(">?", bool(norm.fit_labels)))
        arrays = [norm._f.mean, norm._f.std]
        if norm.fit_labels:
            arrays += [norm._l.mean, norm._l.std]
    elif isinstance(norm, NormalizerMinMaxScaler):
        _write_utf(buf, "MIN_MAX")
        buf.write(struct.pack(">?", bool(norm.fit_labels)))
        buf.write(struct.pack(">dd", float(norm.min_range),
                              float(norm.max_range)))
        arrays = [norm._f.min, norm._f.max]
        if norm.fit_labels:
            arrays += [norm._l.min, norm._l.max]
    else:
        raise ValueError(
            f"{type(norm).__name__} has no upstream normalizer.bin writer "
            "(supported: NormalizerStandardize, NormalizerMinMaxScaler)")
    for a in arrays:
        # stats accumulate in f64 — keep that precision on the wire
        # (large-magnitude means lose up to ~1.0 at f32)
        buf.write(write_nd4j_array(
            np.asarray(a, np.float64).reshape(1, -1), order="f"))
    return buf.getvalue()


def read_normalizer_upstream_format(data: bytes):
    from ..data.normalizers import (NormalizerMinMaxScaler,
                                    NormalizerStandardize)
    buf = io.BytesIO(data)
    strategy = _read_utf(buf)
    (fit_labels,) = struct.unpack(">?", buf.read(1))

    def next_array():
        # read_nd4j_array consumes exactly one frame from the stream
        return np.asarray(read_nd4j_array(buf), np.float64).reshape(-1)

    if strategy == "STANDARDIZE":
        norm = NormalizerStandardize()
        norm.fit_labels = bool(fit_labels)
        norm._f = _stats_from_mean_std(next_array(), next_array())
        if fit_labels:
            norm._l = _stats_from_mean_std(next_array(), next_array())
        return norm
    if strategy == "MIN_MAX":
        lo, hi = struct.unpack(">dd", buf.read(16))
        norm = NormalizerMinMaxScaler(min_range=lo, max_range=hi)
        norm.fit_labels = bool(fit_labels)
        norm._f = _stats_from_min_max(next_array(), next_array())
        if fit_labels:
            norm._l = _stats_from_min_max(next_array(), next_array())
        return norm
    raise ValueError(f"unsupported upstream normalizer strategy "
                     f"{strategy!r} (supported: STANDARDIZE, MIN_MAX)")


# ------------------------------------------------- config-level JSON API --
# Reference: ``MultiLayerConfiguration.toJson()/fromJson()`` and
# ``ComputationGraphConfiguration.toJson()/fromJson()`` — the config-only
# half of the interop (no weights). These power the `to_upstream_json` /
# `from_upstream_json` methods on our configuration classes.


_KIND_TO_RANK = {"ff": 1, "rnn": 2, "cnn": 3, "cnn3d": 4}


def _our_input_type_to_json(it):
    """Our (kind, shape) input-type tuple → upstream InputType JSON,
    dispatching on the KIND tag (not shape-length guessing)."""
    kind, shape = it[0], tuple(it[1])
    if kind not in _KIND_TO_RANK:
        raise ValueError(f"input type kind {kind!r} has no upstream "
                         "InputType analogue")
    if len(shape) != _KIND_TO_RANK[kind]:
        raise ValueError(f"input type {it!r}: kind {kind!r} expects a "
                         f"rank-{_KIND_TO_RANK[kind]} shape")
    return _shape_to_input_type_json(shape)


def mln_conf_to_upstream_json(conf) -> str:
    """Our MultiLayerConfiguration → upstream-format JSON string."""
    confs = []
    for layer in conf.layers:
        confs.append({"layer": _layer_to_json(layer),
                      "seed": int(conf.globals_.seed), "miniBatch": True,
                      "iUpdater": _updater_to_json(conf.globals_.updater)})
    top = {"backpropType": "Standard", "confs": confs}
    if conf.input_type is not None:
        top["inputType"] = _our_input_type_to_json(conf.input_type)
    return json.dumps(top, indent=2)


def mln_conf_from_upstream_json(data):
    """Upstream MultiLayerConfiguration JSON (str or parsed dict) → our
    configuration."""
    from ..nn.conf import NeuralNetConfiguration
    d = json.loads(data) if isinstance(data, (str, bytes)) else data
    if "confs" not in d:
        raise ValueError("not an upstream MultiLayerConfiguration (no "
                         "'confs')")
    layers = [_layer_from_json(c["layer"]) for c in d["confs"]]
    builder = NeuralNetConfiguration.builder()
    if d["confs"]:
        builder = builder.seed(d["confs"][0].get("seed", 12345))
        upd = _updater_from_json(d["confs"][0].get("iUpdater"))
        if upd is not None:
            builder = builder.updater(upd)
    lb = builder.list()
    for lyr in layers:
        lb = lb.layer(lyr)
    it = d.get("inputType")
    if it:
        lb = lb.set_input_type(_input_type_from_json(it))
    return lb.build()


def cg_conf_to_upstream_json(conf) -> str:
    """Our ComputationGraphConfiguration → upstream-format JSON string."""
    from ..nn.layers.base import Layer
    vertices = {}
    vertex_inputs = {}
    for name in conf.topo_order:
        node = conf.nodes[name]
        if isinstance(node.op, Layer):
            vertices[name] = {
                "@class": _GV + "LayerVertex",
                "layerConf": {"layer": _layer_to_json(node.op),
                              "seed": int(conf.globals_.seed),
                              "iUpdater": _updater_to_json(
                                  conf.globals_.updater)}}
        else:
            vertices[name] = _vertex_to_json(node.op)
        vertex_inputs[name] = list(node.inputs)
    top = {"networkInputs": list(conf.inputs),
           "networkOutputs": list(conf.outputs),
           "vertices": vertices,
           "vertexInputs": vertex_inputs}
    if conf.input_types:
        top["inputTypes"] = [_our_input_type_to_json(it)
                             for it in conf.input_types]
    return json.dumps(top, indent=2)


def cg_conf_from_upstream_json(data):
    """Upstream ComputationGraphConfiguration JSON (str or parsed dict) →
    our configuration."""
    from ..nn.conf import NeuralNetConfiguration
    d = json.loads(data) if isinstance(data, (str, bytes)) else data
    if "vertices" not in d:
        raise ValueError("not an upstream ComputationGraphConfiguration "
                         "(no 'vertices')")
    builder = NeuralNetConfiguration.builder()
    upd_json = d.get("iUpdater")
    seed = None
    for vd in d["vertices"].values():
        lc = vd.get("layerConf")
        if lc:
            if upd_json is None and lc.get("iUpdater"):
                upd_json = lc["iUpdater"]   # genuine upstream zips carry
                # the updater inside each LayerVertex's NeuralNetConfiguration
            if seed is None and lc.get("seed") is not None:
                seed = int(lc["seed"])
    if seed is not None:
        builder = builder.seed(seed)
    upd = _updater_from_json(upd_json)
    if upd is not None:
        builder = builder.updater(upd)
    gb = builder.graph_builder()
    gb.add_inputs(*d["networkInputs"])
    vertex_inputs = d.get("vertexInputs", {})
    for name, vd in d["vertices"].items():
        cls = vd.get("@class", "").rsplit(".", 1)[-1]
        ins = vertex_inputs.get(name, [])
        if cls == "LayerVertex":
            gb.add_layer(name, _layer_from_json(vd["layerConf"]["layer"]),
                         *ins)
        else:
            gb.add_vertex(name, _vertex_from_json(vd), *ins)
    gb.set_outputs(*d["networkOutputs"])
    its = d.get("inputTypes")
    if its:
        gb.set_input_types(*[_input_type_from_json(it) for it in its])
    return gb.build()
