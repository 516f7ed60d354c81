"""TF frozen-GraphDef import → SameDiff graph — port of
``deeplearning4j_tpu/autodiff/tf_import.py``.

Reference parity: ``org.nd4j.imports.graphmapper.tf.TFGraphMapper`` —
DL4J runs BERT by importing a frozen TF graph into SameDiff. The port
reads the GraphDef itself: no TensorFlow and no protobuf package (the
machine with the card has neither). ``_protowire`` decodes the wire
format, :class:`GraphDef` & co. give the reader the attribute surface of
TF's generated classes (``node.attr["strides"].list.i`` …), a TensorProto
is decoded by :func:`tensor_to_numpy`, and the output argument names that
the reference asks TF's op registry for are a static table
(:data:`OUTPUT_ARGS`).

Each handler is the reference's, in plain torch. Nodes whose inputs are
all constants are folded at import (the reference's eager constant
folding, with its ``NOFOLD`` set), so that shape and axis plumbing reaches
the handlers as constants, read from their host copies, never from the
card. A node that needs the host while it runs (V2 ``If``/``While`` and
function calls, which run their function bodies eagerly; random ops;
``CheckNumerics``; a static argument, such as a shape, that is not a
constant) marks the graph as one that runs eagerly. V1 Switch/Merge
conditionals compute both branches and select at Merge; V1 loop frames
raise, as in the reference.
"""

from __future__ import annotations

import math
import os
import zlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import sd_ops
from ._protowire import Msg
from .samediff import SameDiff, SDVariable, host_value, set_host_value

# ---------------------------------------------------------------- GraphDef
# DataType enum (tensorflow/core/framework/types.proto)
TF_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
             5: np.int16, 6: np.int8, 7: np.object_, 8: np.complex64,
             9: np.int64, 10: np.bool_, 14: "bfloat16", 17: np.uint16,
             18: np.complex128, 19: np.float16, 22: np.uint32,
             23: np.uint64}


class TensorShape:
    """TensorShapeProto: ``dim`` (each with ``size`` and ``name``) and
    ``unknown_rank``."""

    class Dim:
        def __init__(self, m):
            self.size = m.int(1) if m is not None else 0
            self.name = m.str_(2) if m is not None else ""

    def __init__(self, m: Msg = None):
        self.dim = [TensorShape.Dim(d) for d in m.msgs(2)] if m else []
        self.unknown_rank = bool(m.int(3)) if m else False


class NameAttrList:
    def __init__(self, m: Msg = None):
        self.name = m.str_(1) if m else ""
        self.attr = _attr_map(m.msgs(2)) if m else AttrMap()


class ListValue:
    def __init__(self, m: Msg = None):
        self.s = m.bytes_list(2) if m else []
        self.i = m.ints(3) if m else []
        self.f = m.floats(4) if m else []
        self.b = [bool(v) for v in m.ints(5)] if m else []
        self.type = m.ints(6) if m else []
        self.shape = [TensorShape(s) for s in m.msgs(7)] if m else []
        self.tensor = m.msgs(8) if m else []
        self.func = [NameAttrList(f) for f in m.msgs(9)] if m else []


class AttrValue:
    """AttrValue with proto3 defaults for the fields it does not set."""

    def __init__(self, m: Msg = None):
        self._m = m
        self.s = m.bytes_(2) if m else b""
        self.i = m.int(3) if m else 0
        self.f = m.float(4) if m else 0.0
        self.b = bool(m.int(5)) if m else False
        self.type = m.int(6) if m else 0

    @property
    def list(self):
        return ListValue(self._m.msg(1) if self._m else None)

    @property
    def shape(self):
        return TensorShape(self._m.msg(7) if self._m else None)

    @property
    def tensor(self):
        return self._m.msg(8) if self._m and 8 in self._m.fields else \
            Msg(b"")

    @property
    def func(self):
        return NameAttrList(self._m.msg(10) if self._m else None)


class AttrMap(dict):
    """A node's ``attr`` map; a missing key reads as a default AttrValue,
    as a protobuf map does."""

    def __missing__(self, key):
        return AttrValue()


def _attr_map(entries):
    out = AttrMap()
    for e in entries:
        out[e.str_(1)] = AttrValue(e.msg(2))
    return out


class NodeDef:
    def __init__(self, m: Msg):
        self.name = m.str_(1)
        self.op = m.str_(2)
        self.input = m.strs(3)
        self.device = m.str_(4)
        self.attr = _attr_map(m.msgs(5))


class ArgDef:
    def __init__(self, m: Msg):
        self.name = m.str_(1)
        self.type = m.int(3)


class OpDef:
    def __init__(self, m: Msg):
        self.name = m.str_(1)
        self.input_arg = [ArgDef(a) for a in m.msgs(2)]
        self.output_arg = [ArgDef(a) for a in m.msgs(3)]


class FunctionDef:
    def __init__(self, m: Msg):
        self.signature = OpDef(m.msg(1) or Msg(b""))
        self.node_def = [NodeDef(n) for n in m.msgs(3)]
        self.ret = {e.str_(1): e.str_(2) for e in m.msgs(4)}


class _Library:
    def __init__(self, m: Msg = None):
        self.function = [FunctionDef(f) for f in m.msgs(1)] if m else []


class GraphDef:
    """A GraphDef read from its serialized bytes: ``node`` and
    ``library.function``."""

    def __init__(self, data: bytes):
        m = Msg(data)
        self.node = [NodeDef(n) for n in m.msgs(1)]
        self.library = _Library(m.msg(2))


def tensor_to_numpy(t: Msg) -> np.ndarray:
    """A TensorProto as numpy (``tensor_util.MakeNdarray``'s counterpart):
    ``tensor_content``, else the repeated ``*_val`` field of its dtype
    (a single value fills the shape; fewer values repeat the last); f16
    and bf16 from ``half_val`` bits; bf16 read as float32."""
    code = t.int(1)
    shape_m = t.msg(2)
    shape = tuple(d.int(1) for d in shape_m.msgs(2)) if shape_m else ()
    n = int(np.prod(shape)) if shape else 1
    dt = TF_DTYPES.get(code)
    if dt is None:
        raise NotImplementedError(f"TensorProto dtype enum {code}")
    raw = t.raw(4)
    if dt == "bfloat16":
        if raw is not None:
            bits = np.frombuffer(raw, np.uint16)
        else:
            bits = np.asarray(t.ints(13), np.int64).astype(np.uint16)
        vals = (bits.astype(np.uint32) << 16).view(np.float32)
        return _fill(vals, shape, n, np.float32)
    if dt is np.object_:
        return _fill(np.array(t.bytes_list(8), dtype=object), shape, n,
                     object)
    if raw is not None and len(raw):
        return np.frombuffer(raw, dt).copy().reshape(shape)
    if dt == np.float32:
        vals = np.asarray(t.floats(5), np.float32)
    elif dt == np.float64:
        vals = np.asarray(t.doubles(6), np.float64)
    elif dt == np.float16:
        vals = np.asarray(t.ints(13), np.int64).astype(np.uint16).view(
            np.float16)
    elif dt in (np.int32, np.int16, np.int8, np.uint8, np.uint16):
        vals = np.asarray(t.ints(7), np.int64).astype(dt)
    elif dt == np.int64:
        vals = np.asarray(t.ints(10), np.int64)
    elif dt == np.bool_:
        vals = np.asarray(t.ints(11), np.int64).astype(np.bool_)
    elif dt == np.uint32:
        vals = np.asarray(t.uints(16), np.uint64).astype(np.uint32)
    elif dt == np.uint64:
        vals = np.asarray(t.uints(17), np.uint64)
    elif dt == np.complex64:
        f = np.asarray(t.floats(9), np.float32)
        vals = f[0::2] + 1j * f[1::2]
        vals = vals.astype(np.complex64)
    elif dt == np.complex128:
        f = np.asarray(t.doubles(12), np.float64)
        vals = (f[0::2] + 1j * f[1::2]).astype(np.complex128)
    else:
        raise NotImplementedError(f"TensorProto dtype {dt}")
    return _fill(vals, shape, n, dt)


def _fill(vals, shape, n, dt):
    if vals.size == n:
        return vals.reshape(shape)
    if vals.size == 0:
        return np.zeros(shape, dt) if dt is not object else \
            np.full(shape, b"", dtype=object)
    out = np.empty(n, dtype=vals.dtype)
    out[:vals.size] = vals
    out[vals.size:] = vals[-1]
    return out.reshape(shape)


# The output argument names of the handled ops, as TF's op registry
# (tensorflow/core/ops) declares them: a function body names a node's
# outputs "<node>:<arg>:<index>".
OUTPUT_ARGS = {
    'Abs': ('y',), 'AccumulateNV2': ('sum',), 'Acos': ('y',),
    'Acosh': ('y',), 'Add': ('z',), 'AddN': ('sum',), 'AddV2': ('z',),
    'All': ('output',), 'Angle': ('output',), 'Any': ('output',),
    'ArgMax': ('output',), 'ArgMin': ('output',), 'Asin': ('y',),
    'Asinh': ('y',), 'Atan': ('y',), 'Atan2': ('z',), 'Atanh': ('y',),
    'AvgPool': ('output',), 'AvgPool3D': ('output',),
    'BatchMatMul': ('output',), 'BatchMatMulV2': ('output',),
    'BatchToSpaceND': ('output',), 'Betainc': ('z',), 'BiasAdd': ('output',),
    'Bincount': ('bins',), 'BitwiseAnd': ('z',), 'BitwiseOr': ('z',),
    'BitwiseXor': ('z',), 'BroadcastArgs': ('r0',),
    'BroadcastTo': ('output',), 'Bucketize': ('output',), 'Cast': ('y',),
    'Ceil': ('y',), 'CheckNumerics': ('output',), 'Cholesky': ('output',),
    'ClipByValue': ('output',), 'Complex': ('out',), 'ComplexAbs': ('y',),
    'Concat': ('output',), 'ConcatV2': ('output',), 'Conj': ('output',),
    'Const': ('output',), 'Conv2D': ('output',),
    'Conv2DBackpropInput': ('output',), 'Conv3D': ('output',), 'Cos': ('y',),
    'Cosh': ('y',), 'CropAndResize': ('crops',), 'Cumprod': ('out',),
    'Cumsum': ('out',), 'DepthToSpace': ('output',),
    'DepthwiseConv2dNative': ('output',), 'Digamma': ('y',),
    'Dilation2D': ('output',), 'Div': ('z',),
    'DrawBoundingBoxes': ('output',), 'DrawBoundingBoxesV2': ('output',),
    'DynamicPartition': ('outputs',), 'DynamicStitch': ('merged',),
    'Einsum': ('output',), 'Elu': ('activations',),
    'EnsureShape': ('output',), 'Enter': ('output',), 'Equal': ('z',),
    'Erf': ('y',), 'Erfc': ('y',), 'Erfinv': ('y',), 'Exit': ('output',),
    'Exp': ('y',), 'ExpandDims': ('output',), 'Expm1': ('y',),
    'FFT': ('output',), 'FFT2D': ('output',),
    'FakeQuantWithMinMaxArgs': ('outputs',), 'Fill': ('output',),
    'Floor': ('y',), 'FloorDiv': ('z',), 'FloorMod': ('z',),
    'FusedBatchNorm': ('y', 'batch_mean', 'batch_variance', 'reserve_space_1', 'reserve_space_2'),
    'FusedBatchNormV3': ('y', 'batch_mean', 'batch_variance', 'reserve_space_1', 'reserve_space_2', 'reserve_space_3'),
    'Gather': ('output',), 'GatherNd': ('output',), 'GatherV2': ('output',),
    'Greater': ('z',), 'GreaterEqual': ('z',),
    'HistogramFixedWidth': ('out',), 'IFFT': ('output',),
    'IFFT2D': ('output',), 'IRFFT': ('output',), 'Identity': ('output',),
    'IdentityN': ('output',), 'If': ('output',), 'Igamma': ('z',),
    'Igammac': ('z',), 'Imag': ('output',), 'Inv': ('y',), 'Invert': ('y',),
    'InvertPermutation': ('y',), 'IsFinite': ('y',), 'IsInf': ('y',),
    'IsNan': ('y',), 'L2Loss': ('output',), 'LRN': ('output',),
    'LeakyRelu': ('activations',), 'LeftShift': ('z',), 'Less': ('z',),
    'LessEqual': ('z',), 'Lgamma': ('y',), 'LinSpace': ('output',),
    'Log': ('y',), 'Log1p': ('y',),
    'LogMatrixDeterminant': ('sign', 'log_abs_determinant'),
    'LogSoftmax': ('logsoftmax',), 'LogicalAnd': ('z',),
    'LogicalNot': ('y',), 'LogicalOr': ('z',), 'LoopCond': ('output',),
    'MatMul': ('product',), 'MatrixBandPart': ('band',),
    'MatrixDeterminant': ('output',), 'MatrixDiag': ('output',),
    'MatrixDiagPart': ('diagonal',), 'MatrixInverse': ('output',),
    'Max': ('output',), 'MaxPool': ('output',), 'MaxPool3D': ('output',),
    'Maximum': ('z',), 'Mean': ('output',), 'Min': ('output',),
    'Minimum': ('z',), 'MirrorPad': ('output',), 'Mod': ('z',),
    'Mul': ('z',), 'Multinomial': ('output',), 'Ndtri': ('y',),
    'Neg': ('y',), 'NextIteration': ('output',), 'NoOp': (),
    'NonMaxSuppressionV3': ('selected_indices',),
    'NonMaxSuppressionV4': ('selected_indices', 'valid_outputs'),
    'NotEqual': ('z',), 'OneHot': ('output',), 'OnesLike': ('y',),
    'Pack': ('output',), 'Pad': ('output',), 'PadV2': ('output',),
    'ParallelDynamicStitch': ('merged',), 'PartitionedCall': ('output',),
    'Placeholder': ('output',), 'Polygamma': ('z',), 'Pow': ('z',),
    'PreventGradient': ('output',), 'Prod': ('output',), 'RFFT': ('output',),
    'RandomStandardNormal': ('output',), 'RandomUniform': ('output',),
    'RandomUniformInt': ('output',), 'Range': ('output',),
    'Rank': ('output',), 'Real': ('output',), 'RealDiv': ('z',),
    'Reciprocal': ('y',), 'Relu': ('activations',),
    'Relu6': ('activations',), 'Reshape': ('output',),
    'ResizeBicubic': ('resized_images',),
    'ResizeBilinear': ('resized_images',),
    'ResizeNearestNeighbor': ('resized_images',), 'ReverseV2': ('output',),
    'RightShift': ('z',), 'Rint': ('y',), 'Roll': ('output',),
    'Round': ('y',), 'Rsqrt': ('y',), 'ScatterNd': ('output',),
    'SegmentMax': ('output',), 'SegmentMean': ('output',),
    'SegmentMin': ('output',), 'SegmentProd': ('output',),
    'SegmentSum': ('output',), 'Select': ('output',),
    'SelectV2': ('output',), 'Selu': ('activations',), 'Shape': ('output',),
    'Sigmoid': ('y',), 'Sign': ('y',), 'Sin': ('y',), 'Sinh': ('y',),
    'Size': ('output',), 'Slice': ('output',), 'Snapshot': ('output',),
    'Softmax': ('softmax',),
    'SoftmaxCrossEntropyWithLogits': ('loss', 'backprop'),
    'Softplus': ('activations',), 'Softsign': ('activations',),
    'SpaceToBatchND': ('output',), 'SpaceToDepth': ('output',),
    'SparseSoftmaxCrossEntropyWithLogits': ('loss', 'backprop'),
    'Split': ('output',), 'SplitV': ('output',), 'Sqrt': ('y',),
    'Square': ('y',), 'SquaredDifference': ('z',), 'Squeeze': ('output',),
    'StatefulPartitionedCall': ('output',), 'StatelessIf': ('output',),
    'StatelessWhile': ('output',), 'StopGradient': ('output',),
    'StridedSlice': ('output',), 'Sub': ('z',), 'Sum': ('output',),
    'Tan': ('y',), 'Tanh': ('y',), 'TensorScatterAdd': ('output',),
    'TensorScatterUpdate': ('output',), 'Tile': ('output',),
    'TopKV2': ('values', 'indices'), 'Transpose': ('y',),
    'TruncatedNormal': ('output',), 'Unpack': ('output',),
    'UnsortedSegmentMax': ('output',), 'UnsortedSegmentMin': ('output',),
    'UnsortedSegmentProd': ('output',), 'UnsortedSegmentSum': ('output',),
    'While': ('output',), 'Xdivy': ('z',), 'Xlog1py': ('z',),
    'Xlogy': ('z',), 'ZerosLike': ('y',), 'Zeta': ('z',),
}

# ------------------------------------------------------------- handlers

def _axes(v):
    return tuple(int(a) for a in np.asarray(host_value(v)).ravel())


def _int(v):
    return int(np.asarray(host_value(v)).reshape(-1)[0])


def _float(v):
    return float(np.asarray(host_value(v)).reshape(-1)[0])


def _attr_f(node, name, default):
    """Float attr with an explicit-presence check: an attr set to 0.0
    must not fall back to the default."""
    return node.attr[name].f if name in node.attr else default


def _pair(a, b):
    return sd_ops._bin(a, b)


def _binary(fn):
    def h(i, n):
        a, b = _pair(i[0], i[1])
        return fn(a, b)
    return h


def _unary(fn, inexact=True):
    def h(i, n):
        return fn(sd_ops._fl(i[0]) if inexact else i[0])
    return h


# static input positions of the handlers that read a value on the host:
# when such an input is not a constant the node needs the host
_STATIC = {
    "Reshape": (1,), "Transpose": (1,), "ExpandDims": (1,),
    "ConcatV2": (-1,), "Split": (0,), "SplitV": (1, 2),
    "StridedSlice": (1, 2, 3), "Slice": (1, 2), "GatherV2": (2,),
    "Gather": (2,), "OneHot": (1,), "Mean": (1,), "Sum": (1,), "Max": (1,),
    "Min": (1,), "Prod": (1,), "All": (1,), "Any": (1,), "ArgMax": (1,),
    "ArgMin": (1,), "Fill": (0,), "Tile": (1,), "Cumsum": (1,),
    "Cumprod": (1,), "Pad": (1,), "PadV2": (1, 2), "MirrorPad": (1,),
    "Concat": (0,), "ReverseV2": (1,), "Range": (0, 1, 2),
    "LinSpace": (0, 1, 2), "BroadcastTo": (1,), "ScatterNd": (2,),
    "MatrixBandPart": (1, 2), "Conv2DBackpropInput": (0,),
    "ResizeBilinear": (1,), "ResizeNearestNeighbor": (1,),
    "ResizeBicubic": (1,), "RFFT": (1,), "IRFFT": (1,), "TopKV2": (1,),
    "SegmentSum": (1,), "SegmentMean": (1,), "SegmentMax": (1,),
    "SegmentMin": (1,), "SegmentProd": (1,), "UnsortedSegmentSum": (2,),
    "UnsortedSegmentMax": (2,), "UnsortedSegmentMin": (2,),
    "UnsortedSegmentProd": (2,), "Bincount": (1,), "DynamicPartition": (1,),
    "SpaceToBatchND": (1, 2), "BatchToSpaceND": (1, 2),
    "NonMaxSuppressionV3": (2, 3, 4), "NonMaxSuppressionV4": (2, 3, 4),
    "CropAndResize": (3,), "Roll": (1, 2), "HistogramFixedWidth": (1, 2),
    "BroadcastArgs": (0, 1), "RandomUniform": (0,),
    "RandomStandardNormal": (0,), "TruncatedNormal": (0,),
    "RandomUniformInt": (0, 1, 2), "Multinomial": (1,), "Polygamma": (0,),
}

# ops that always need the host while they run
_HOST_OPS = {"If", "StatelessIf", "While", "StatelessWhile",
             "PartitionedCall", "StatefulPartitionedCall", "CheckNumerics",
             "RandomUniform", "RandomStandardNormal", "TruncatedNormal",
             "RandomUniformInt", "Multinomial", "DynamicPartition"}


class TFImporter:
    def __init__(self):
        B, U = _binary, _unary
        self.handlers = {
            "Const": None, "Placeholder": None, "Identity": self._identity,
            "IdentityN": self._identity, "NoOp": None,
            "MatMul": self._matmul, "BatchMatMul": self._batch_matmul,
            "BatchMatMulV2": self._batch_matmul,
            "BiasAdd": B(torch.add),
            "Add": B(torch.add), "AddV2": B(torch.add),
            "AddN": lambda i, n: sum(i[1:], start=i[0]),
            "Sub": B(torch.sub), "Mul": B(torch.mul),
            "RealDiv": B(torch.true_divide), "Div": B(torch.true_divide),
            "Maximum": B(torch.maximum), "Minimum": B(torch.minimum),
            "Pow": lambda i, n: self._pow(i[0], i[1]),
            "SquaredDifference": lambda i, n: torch.square(
                B(torch.sub)(i, n)),
            "Square": lambda i, n: torch.square(i[0]),
            "Sqrt": U(torch.sqrt),
            "Rsqrt": U(torch.rsqrt),
            "Exp": U(torch.exp), "Log": U(torch.log),
            "Neg": lambda i, n: -i[0], "Abs": lambda i, n: torch.abs(i[0]),
            "Tanh": U(torch.tanh),
            "Sigmoid": U(torch.sigmoid),
            "Relu": lambda i, n: F.relu(i[0]),
            "Relu6": lambda i, n: F.relu6(i[0]),
            "Elu": lambda i, n: F.elu(i[0]),
            "Selu": lambda i, n: F.selu(i[0]),
            "Softplus": lambda i, n: F.softplus(i[0]),
            "Erf": U(torch.special.erf),
            "Softmax": lambda i, n: torch.softmax(i[0], dim=-1),
            "LogSoftmax": lambda i, n: torch.log_softmax(i[0], dim=-1),
            "Reshape": lambda i, n: i[0].reshape(_axes(i[1])),
            "Transpose": lambda i, n: i[0].permute(*_axes(i[1])),
            "ExpandDims": lambda i, n: torch.unsqueeze(i[0], _int(i[1])),
            "Squeeze": self._squeeze,
            "ConcatV2": lambda i, n: torch.cat(
                sd_ops._promote(*i[:-1]), dim=_int(i[-1])),
            "Pack": self._pack, "Unpack": self._unpack,
            "Split": self._split, "SplitV": self._splitv,
            "StridedSlice": self._strided_slice,
            "Slice": self._slice,
            "GatherV2": self._gather, "Gather": self._gather,
            "OneHot": self._one_hot,
            "Cast": self._cast,
            "Mean": self._mean, "Sum": self._sum, "Max": self._rmax,
            "Min": self._rmin, "Prod": self._prod,
            "ArgMax": lambda i, n: sd_ops._argmax(i[0], _int(i[1])),
            "Shape": lambda i, n: _int_vector(i[0].shape, i[0].device),
            "Rank": lambda i, n: _int_vector(i[0].ndim, i[0].device),
            "Fill": lambda i, n: torch.broadcast_to(
                i[1], _axes(i[0])).clone(),
            "ZerosLike": lambda i, n: torch.zeros_like(i[0]),
            "OnesLike": lambda i, n: torch.ones_like(i[0]),
            "Tile": lambda i, n: torch.tile(i[0], _axes(i[1])),
            "StopGradient": lambda i, n: i[0].detach(),
            "Rsub": lambda i, n: B(torch.sub)([i[1], i[0]], n),
            "Einsum": lambda i, n: sd_ops._einsum(
                n.attr["equation"].s.decode(), *i),
            "FusedBatchNorm": self._fused_bn,
            "FusedBatchNormV3": self._fused_bn,
            "Conv2D": self._conv2d, "MaxPool": self._maxpool,
            "AvgPool": self._avgpool,
            "Greater": B(torch.gt), "GreaterEqual": B(torch.ge),
            "Less": B(torch.lt), "Equal": B(torch.eq),
            "NotEqual": B(torch.ne),
            "Select": self._select, "SelectV2": self._select,
            "Tanh_": U(torch.tanh),
            # --- r3 widening: the broad frozen-graph long tail ------------
            "Floor": U(torch.floor), "Ceil": U(torch.ceil),
            "Round": lambda i, n: torch.round(i[0]),
            "Rint": lambda i, n: torch.round(i[0]),
            "Sign": lambda i, n: torch.sign(i[0]),
            "FloorDiv": lambda i, n: sd_ops._floor_divide(i[0], i[1]),
            "FloorMod": lambda i, n: sd_ops._remainder(i[0], i[1]),
            "Mod": lambda i, n: sd_ops._fmod(i[0], i[1]),  # TF Mod truncates
            "Log1p": U(torch.log1p), "Expm1": U(torch.expm1),
            "Sin": U(torch.sin), "Cos": U(torch.cos), "Tan": U(torch.tan),
            "Asin": U(torch.asin), "Acos": U(torch.acos),
            "Atan": U(torch.atan), "Sinh": U(torch.sinh),
            "Cosh": U(torch.cosh), "Asinh": U(torch.asinh),
            "Acosh": U(torch.acosh), "Atanh": U(torch.atanh),
            "Atan2": lambda i, n: sd_ops._atan2(i[0], i[1]),
            "Reciprocal": U(torch.reciprocal), "Inv": U(torch.reciprocal),
            "Erfc": U(torch.special.erfc),
            "LeakyRelu": lambda i, n: F.leaky_relu(
                i[0], _attr_f(n, "alpha", 0.2)),
            "Softsign": lambda i, n: F.softsign(i[0]),
            "IsNan": lambda i, n: torch.isnan(i[0]),
            "IsInf": lambda i, n: torch.isinf(i[0]),
            "IsFinite": lambda i, n: torch.isfinite(i[0]),
            "LogicalAnd": B(torch.logical_and),
            "LogicalOr": B(torch.logical_or),
            "LogicalNot": lambda i, n: torch.logical_not(i[0]),
            "LessEqual": B(torch.le),
            "All": self._rall, "Any": self._rany,
            "ArgMin": lambda i, n: sd_ops._argmin(i[0], _int(i[1])),
            "Cumsum": self._cumsum, "Cumprod": self._cumprod,
            "Pad": lambda i, n: sd_ops._pad(i[0], host_value(i[1])),
            "PadV2": lambda i, n: sd_ops._pad(i[0], host_value(i[1]),
                                              value=_float(i[2])),
            "MirrorPad": lambda i, n: sd_ops._pad(
                i[0], host_value(i[1]),
                mode=("reflect" if n.attr["mode"].s == b"REFLECT"
                      else "symmetric")),
            "Concat": lambda i, n: torch.cat(
                sd_ops._promote(*i[1:]), dim=_int(i[0])),  # axis FIRST
            "ReverseV2": lambda i, n: torch.flip(i[0], _axes(i[1])),
            "Range": self._range,
            "LinSpace": lambda i, n: torch.linspace(
                _float(i[0]), _float(i[1]), _int(i[2]),
                dtype=torch.float32),
            "Size": lambda i, n: _int_vector(i[0].numel(), i[0].device),
            "BroadcastTo": lambda i, n: torch.broadcast_to(
                i[0], _axes(i[1])).clone(),
            "GatherNd": lambda i, n: sd_ops._gather_nd(i[0], i[1]),
            "ScatterNd": lambda i, n: sd_ops._scatter_nd(i[0], i[1],
                                                         _axes(i[2])),
            "TensorScatterUpdate": lambda i, n: sd_ops._scatter_nd_onto(
                "set")(i[0], i[1], i[2]),
            "TensorScatterAdd": lambda i, n: sd_ops._scatter_nd_onto(
                "add")(i[0], i[1], i[2]),
            "InvertPermutation": lambda i, n: sd_ops._argsort(i[0]),
            "MatrixBandPart": lambda i, n: sd_ops._matrix_band_part(
                i[0], _int(i[1]), _int(i[2])),
            "MatrixDiag": lambda i, n: sd_ops._matrix_diag(i[0]),
            "MatrixDiagPart": lambda i, n: torch.diagonal(
                i[0], dim1=-2, dim2=-1).clone(),
            "L2Loss": lambda i, n: 0.5 * torch.sum(torch.square(i[0])),
            "LRN": self._lrn,
            "DepthwiseConv2dNative": self._depthwise_conv2d,
            "Conv2DBackpropInput": self._conv2d_transpose,
            "SpaceToDepth": lambda i, n: sd_ops._space_to_depth(
                i[0], n.attr["block_size"].i),
            "DepthToSpace": lambda i, n: sd_ops._depth_to_space(
                i[0], n.attr["block_size"].i),
            "ResizeBilinear": self._resize_bilinear,
            "ResizeNearestNeighbor": self._resize_nearest,
            # spectral family
            "FFT": lambda i, n: torch.fft.fft(i[0]),
            "IFFT": lambda i, n: torch.fft.ifft(i[0]),
            "FFT2D": lambda i, n: torch.fft.fft2(i[0]),
            "IFFT2D": lambda i, n: torch.fft.ifft2(i[0]),
            "RFFT": lambda i, n: torch.fft.rfft(
                sd_ops._fl(i[0]), n=_axes(i[1])[0] if len(i) > 1 else None),
            "IRFFT": lambda i, n: torch.fft.irfft(
                i[0], n=_axes(i[1])[0] if len(i) > 1 else None),
            "ComplexAbs": lambda i, n: torch.abs(i[0]),
            "Real": lambda i, n: torch.real(i[0]).clone(),
            "Imag": lambda i, n: torch.imag(i[0]).clone(),
            "Conj": lambda i, n: torch.conj_physical(i[0]),
            "Complex": lambda i, n: torch.complex(i[0], i[1]),
            "Angle": lambda i, n: torch.angle(i[0]),
            # --- r4 widening: arbitrary-frozen-graph generality -----------
            "ClipByValue": lambda i, n: sd_ops._clip(i[0], i[1], i[2]),
            "Xlogy": lambda i, n: sd_ops._xlogy(i[0], i[1]),
            "Xlog1py": lambda i, n: torch.special.xlog1py(
                *sd_ops._promote(sd_ops._fl(i[0]), sd_ops._fl(i[1]))),
            "Xdivy": lambda i, n: torch.where(
                i[0] == 0, 0.0, i[0] / torch.where(i[0] == 0, 1.0, i[1])),
            "Digamma": U(torch.special.digamma),
            "Lgamma": U(torch.lgamma),
            "Igamma": lambda i, n: sd_ops._igamma(i[0], i[1]),
            "Igammac": lambda i, n: sd_ops._igammac(i[0], i[1]),
            "Polygamma": lambda i, n: self._polygamma(i[0], i[1]),
            "Zeta": lambda i, n: sd_ops._zeta(i[0], i[1]),
            "Betainc": lambda i, n: sd_ops._betainc(i[0], i[1], i[2]),
            "Erfinv": U(torch.special.erfinv),
            "Ndtri": U(torch.special.ndtri),
            "TopKV2": self._topk,
            "SegmentSum": lambda i, n: self._segment(i, "sum"),
            "SegmentMean": lambda i, n: self._segment(i, "mean"),
            "SegmentMax": lambda i, n: self._segment(i, "max"),
            "SegmentMin": lambda i, n: self._segment(i, "min"),
            "SegmentProd": lambda i, n: self._segment(i, "prod"),
            "UnsortedSegmentSum": lambda i, n: self._segment(
                i, "sum", unsorted=True),
            "UnsortedSegmentMax": lambda i, n: self._segment(
                i, "max", unsorted=True),
            "UnsortedSegmentMin": lambda i, n: self._segment(
                i, "min", unsorted=True),
            "UnsortedSegmentProd": lambda i, n: self._segment(
                i, "prod", unsorted=True),
            "Bincount": self._bincount,
            "DynamicPartition": self._dynamic_partition,
            "DynamicStitch": self._dynamic_stitch,
            "ParallelDynamicStitch": self._dynamic_stitch,
            "SpaceToBatchND": lambda i, n: sd_ops._space_to_batch_nd(
                i[0], _axes(i[1]), [tuple(r) for r in host_value(i[2])]),
            "BatchToSpaceND": lambda i, n: sd_ops._batch_to_space_nd(
                i[0], _axes(i[1]), [tuple(r) for r in host_value(i[2])]),
            "Dilation2D": self._dilation2d,
            "Conv3D": self._conv3d,
            "MaxPool3D": self._maxpool3d,
            "AvgPool3D": self._avgpool3d,
            "FakeQuantWithMinMaxArgs": self._fake_quant_args,
            "CheckNumerics": self._check_numerics,
            "Snapshot": self._identity,
            "PreventGradient": self._identity,
            "EnsureShape": self._identity,
            "NonMaxSuppressionV3": self._nms_v3,
            "NonMaxSuppressionV4": self._nms_v4,
            "CropAndResize": self._crop_and_resize,
            "ResizeBicubic": self._resize_bicubic,
            "DrawBoundingBoxesV2": self._draw_boxes,
            "DrawBoundingBoxes": self._draw_boxes,
            "MatrixDeterminant": lambda i, n: torch.linalg.det(i[0]),
            "MatrixInverse": lambda i, n: torch.linalg.inv(i[0]),
            "Cholesky": lambda i, n: torch.linalg.cholesky(i[0]),
            "LogMatrixDeterminant": lambda i, n: list(
                torch.linalg.slogdet(i[0])),
            "SoftmaxCrossEntropyWithLogits": self._softmax_xent,
            "SparseSoftmaxCrossEntropyWithLogits": self._sparse_softmax_xent,
            "Roll": lambda i, n: torch.roll(i[0], _axes(i[1]), _axes(i[2])),
            "Bucketize": lambda i, n: sd_ops._i32(torch.searchsorted(
                sd_ops._t(np.asarray(n.attr["boundaries"].list.f,
                                     np.float32)).to(i[0].device),
                sd_ops._fl(i[0]).float(), right=True)),
            # TF clamps out-of-range values into the edge bins
            "HistogramFixedWidth": self._histogram_fixed_width,
            "BroadcastArgs": lambda i, n: _int_vector(
                np.broadcast_shapes(_axes(i[0]), _axes(i[1])), None),
            "LeftShift": lambda i, n: sd_ops._shift_left(i[0], i[1]),
            "RightShift": lambda i, n: sd_ops._shift_right(i[0], i[1]),
            "BitwiseAnd": B(torch.bitwise_and),
            "BitwiseOr": B(torch.bitwise_or),
            "BitwiseXor": B(torch.bitwise_xor),
            "Invert": lambda i, n: torch.bitwise_not(i[0]),
            "AccumulateNV2": lambda i, n: sum(i[1:], start=i[0]),
            "RandomUniform": lambda i, n: torch.rand(
                _axes(i[0]), generator=self._node_gen(n),
                device=self._device).to(torch.float32),
            "RandomStandardNormal": lambda i, n: torch.randn(
                _axes(i[0]), generator=self._node_gen(n),
                device=self._device),
            "TruncatedNormal": lambda i, n: sd_ops._truncated_normal(
                self._node_gen(n), _axes(i[0])),
            "RandomUniformInt": lambda i, n: sd_ops._randint(
                self._node_gen(n), _axes(i[0]), _int(i[1]), _int(i[2])),
            "Multinomial": lambda i, n: self._multinomial(i, n),
            # --- control flow: V2 functional ops (run eagerly) ------------
            "If": self._if, "StatelessIf": self._if,
            "While": self._while, "StatelessWhile": self._while,
            "PartitionedCall": self._call, "StatefulPartitionedCall":
                self._call,
            # V1 Switch/Merge conditionals are wired in import_graph; V1
            # loop frames raise
            "Enter": self._v1_loop_err, "Exit": self._v1_loop_err,
            "NextIteration": self._v1_loop_err,
            "LoopCond": self._v1_loop_err,
        }
        # ops with >1 output: op type -> (node -> output count)
        self.multi_output = {
            "Split": lambda n: n.attr["num_split"].i,
            "SplitV": lambda n: n.attr["num_split"].i,
            "Unpack": lambda n: n.attr["num"].i,
            "TopKV2": lambda n: 2,
            "LogMatrixDeterminant": lambda n: 2,
            "SoftmaxCrossEntropyWithLogits": lambda n: 2,
            "SparseSoftmaxCrossEntropyWithLogits": lambda n: 2,
            "NonMaxSuppressionV4": lambda n: 2,
            "DynamicPartition": lambda n: n.attr["num_partitions"].i,
            "If": lambda n: len(n.attr["Tout"].list.type),
            "StatelessIf": lambda n: len(n.attr["Tout"].list.type),
            "While": lambda n: len(n.attr["T"].list.type),
            "StatelessWhile": lambda n: len(n.attr["T"].list.type),
            "PartitionedCall": lambda n: len(n.attr["Tout"].list.type),
            "StatefulPartitionedCall":
                lambda n: len(n.attr["Tout"].list.type),
        }
        self._functions = {}
        self._device = torch.device("cpu")
        self._sd = None

    # --- handlers needing node attrs ---------------------------------------
    def _identity(self, i, n):
        return i[0]

    def _pow(self, a, b):
        from .samediff import _power
        return _power(a, b)

    def _matmul(self, i, n):
        a, b = sd_ops._promote(i[0], i[1])
        if n.attr["transpose_a"].b:
            a = a.T
        if n.attr["transpose_b"].b:
            b = b.T
        return a @ b

    def _batch_matmul(self, i, n):
        a, b = sd_ops._promote(i[0], i[1])
        if n.attr["adj_x"].b:
            a = a.transpose(-1, -2)
        if n.attr["adj_y"].b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def _select(self, i, n):
        a, b = _pair(i[1], i[2])
        c = i[0].bool()
        if n.op == "Select" and c.ndim == 1 and a.ndim > 1:
            c = c.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(c, a, b)

    def _squeeze(self, i, n):
        dims = tuple(n.attr["squeeze_dims"].list.i)
        return i[0].squeeze(dims) if dims else i[0].squeeze()

    def _pack(self, i, n):
        return torch.stack(sd_ops._promote(*i), dim=n.attr["axis"].i)

    def _unpack(self, i, n):
        return list(torch.unbind(i[0], dim=n.attr["axis"].i))

    def _split(self, i, n):
        return list(torch.chunk(i[1], n.attr["num_split"].i, dim=_int(i[0])))

    def _splitv(self, i, n):
        sizes = list(_axes(i[1]))
        ax = _int(i[2])
        if -1 in sizes:
            k = sizes.index(-1)
            sizes[k] = i[0].shape[ax] - (sum(sizes) + 1)
        return list(torch.split(i[0], sizes, dim=ax))

    def _strided_slice(self, i, n):
        x, begin, end, strides = i[0], _axes(i[1]), _axes(i[2]), _axes(i[3])
        bm = n.attr["begin_mask"].i
        em = n.attr["end_mask"].i
        sm = n.attr["shrink_axis_mask"].i
        nm = n.attr["new_axis_mask"].i
        el = n.attr["ellipsis_mask"].i
        idx = []
        for d in range(len(begin)):
            if el & (1 << d):
                idx.append(Ellipsis)
            elif nm & (1 << d):
                idx.append(None)
            elif sm & (1 << d):
                idx.append(begin[d])
            else:
                b = None if (bm & (1 << d)) else begin[d]
                e = None if (em & (1 << d)) else end[d]
                idx.append(slice(b, e, strides[d]))
        return _getitem(x, idx)

    def _slice(self, i, n):
        begin = _axes(i[1])
        size = _axes(i[2])
        size = tuple(d - b if s == -1 else s
                     for b, s, d in zip(begin, size, i[0].shape))
        return sd_ops._slice(i[0], begin, size)

    def _gather(self, i, n):
        ax = _int(i[2]) if len(i) > 2 else 0
        return sd_ops._take(i[0], i[1], axis=ax)

    def _one_hot(self, i, n):
        depth = _int(i[1])
        on = i[2] if len(i) > 2 else 1.0
        off = i[3] if len(i) > 3 else 0.0
        oh = sd_ops._one_hot(i[0], depth)
        return oh * on + (1 - oh) * off

    _TF_DTYPES = {1: torch.float32, 2: torch.float32, 3: torch.int32,
                  9: torch.int32, 10: torch.bool, 14: torch.bfloat16,
                  19: torch.float16}

    def _cast(self, i, n):
        dt = self._TF_DTYPES.get(n.attr["DstT"].type, torch.float32)
        return sd_ops._cast(i[0], dt)

    def _reduce(self, fn, i, n):
        return fn(i[0], _axes(i[1]), keepdims=n.attr["keep_dims"].b)

    def _mean(self, i, n):
        return self._reduce(sd_ops._mean, i, n)

    def _sum(self, i, n):
        return self._reduce(sd_ops._sum, i, n)

    def _rmax(self, i, n):
        return self._reduce(sd_ops._amax, i, n)

    def _rmin(self, i, n):
        return self._reduce(sd_ops._amin, i, n)

    def _prod(self, i, n):
        return self._reduce(sd_ops._prod, i, n)

    def _rall(self, i, n):
        return self._reduce(sd_ops._alls, i, n)

    def _rany(self, i, n):
        return self._reduce(sd_ops._any, i, n)

    def _cumsum(self, i, n):
        ax = _int(i[1])
        x = torch.flip(i[0], (ax,)) if n.attr["reverse"].b else i[0]
        y = sd_ops._cumsum(x, ax)
        if n.attr["exclusive"].b:
            y = y - x
        return torch.flip(y, (ax,)) if n.attr["reverse"].b else y

    def _cumprod(self, i, n):
        ax = _int(i[1])
        x = torch.flip(i[0], (ax,)) if n.attr["reverse"].b else i[0]
        y = sd_ops._cumprod(x, ax)
        if n.attr["exclusive"].b:
            lead = list(x.shape)
            lead[ax] = 1
            y = torch.cat([torch.ones(lead, dtype=y.dtype, device=y.device),
                           y.narrow(ax, 0, x.shape[ax] - 1)], dim=ax)
        return torch.flip(y, (ax,)) if n.attr["reverse"].b else y

    def _range(self, i, n):
        vals = [np.asarray(host_value(v)).reshape(-1)[0] for v in i[:3]]
        if all(np.issubdtype(np.asarray(v).dtype, np.integer)
               for v in vals):
            return torch.arange(int(vals[0]), int(vals[1]), int(vals[2]),
                                dtype=torch.int32)
        return torch.arange(float(vals[0]), float(vals[1]),
                            float(vals[2]), dtype=torch.float32)

    def _lrn(self, i, n):
        r = n.attr["depth_radius"].i if "depth_radius" in n.attr else 5
        return sd_ops._lrn(i[0], r, _attr_f(n, "bias", 1.0),
                           _attr_f(n, "alpha", 1.0), _attr_f(n, "beta", 0.5))

    def _depthwise_conv2d(self, i, n):
        strides = tuple(n.attr["strides"].list.i)[1:3]
        pad = n.attr["padding"].s.decode()
        w = i[1]  # TF (kh, kw, cin, mult) → HWIO (kh, kw, 1, cin*mult)
        kh, kw, cin, mult = w.shape
        return sd_ops._conv_general(i[0], w.reshape(kh, kw, 1, cin * mult),
                                    strides, pad, groups=cin)

    def _conv2d_transpose(self, i, n):
        # the gradient of a conv: dy dilated by the stride, padded with
        # the transposed forward pads, convolved with the flipped,
        # io-swapped kernel
        strides = tuple(n.attr["strides"].list.i)[1:3]
        padding = n.attr["padding"].s.decode()
        dy = i[2]
        oh, ow = (int(v) for v in _axes(i[0])[1:3])
        w = i[1]
        kh, kw = w.shape[:2]
        wf = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)

        def grad_pad(out_sz, in_sz, k, s):
            if padding == "SAME":
                fwd_out = -(-out_sz // s)
                total = max(0, (fwd_out - 1) * s + k - out_sz)
                fwd_lo = total // 2
            else:
                fwd_lo = 0
            lo = k - 1 - fwd_lo
            dil = (in_sz - 1) * s + 1
            hi = out_sz + k - 1 - dil - lo
            return lo, hi

        ph = grad_pad(oh, dy.shape[1], kh, strides[0])
        pw = grad_pad(ow, dy.shape[2], kw, strides[1])
        return sd_ops._conv_general(dy, wf, (1, 1), (ph, pw),
                                    lhs_dilation=strides)

    def _resize_coords(self, n, in_dim, out_dim, clamp_half_pixel=True):
        """Source sample coordinates for TF's three resize conventions
        (align_corners / half_pixel_centers / legacy)."""
        if n.attr["align_corners"].b and out_dim > 1:
            return torch.linspace(0.0, in_dim - 1, out_dim,
                                  dtype=torch.float32)
        if n.attr["half_pixel_centers"].b:
            scale = in_dim / out_dim
            c = (torch.arange(out_dim, dtype=torch.float32) + 0.5) * scale \
                - 0.5
            return torch.clamp_min(c, 0.0) if clamp_half_pixel else c
        return torch.arange(out_dim, dtype=torch.float32) * (in_dim
                                                             / out_dim)

    def _resize_bilinear(self, i, n):
        x = i[0]
        oh, ow = _axes(i[1])
        b, h, w, c = x.shape
        ys = self._resize_coords(n, h, oh).to(x.device)
        xs = self._resize_coords(n, w, ow).to(x.device)
        y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        x1 = torch.clamp(x0 + 1, 0, w - 1)
        xf = sd_ops._fl(x)
        wy = (ys - y0)[None, :, None, None].to(xf.dtype)
        wx = (xs - x0)[None, None, :, None].to(xf.dtype)
        top = xf[:, y0][:, :, x0] * (1 - wx) + xf[:, y0][:, :, x1] * wx
        bot = xf[:, y1][:, :, x0] * (1 - wx) + xf[:, y1][:, :, x1] * wx
        return top * (1 - wy) + bot * wy

    def _resize_nearest(self, i, n):
        x = i[0]
        oh, ow = _axes(i[1])
        b, h, w, c = x.shape
        ys = self._resize_coords(n, h, oh).to(x.device)
        xs = self._resize_coords(n, w, ow).to(x.device)
        # TF rounds half away from zero (coords are >= 0: floor(x + 0.5))
        rnd = ((lambda v: torch.floor(v + 0.5))
               if (n.attr["align_corners"].b
                   or n.attr["half_pixel_centers"].b) else torch.floor)
        yi = torch.clamp(rnd(ys).long(), 0, h - 1)
        xi = torch.clamp(rnd(xs).long(), 0, w - 1)
        return x[:, yi][:, :, xi]

    def _fused_bn(self, i, n):
        x, gamma, beta, mean, var = i[:5]
        eps = n.attr["epsilon"].f or 1e-3
        return (x - mean) * torch.rsqrt(var + eps) * gamma + beta

    def _conv2d(self, i, n):
        strides = tuple(n.attr["strides"].list.i)[1:3]
        pad = n.attr["padding"].s.decode()
        return sd_ops._conv_general(i[0], i[1], strides, pad)

    def _maxpool(self, i, n):
        k = tuple(n.attr["ksize"].list.i)[1:-1]
        s = tuple(n.attr["strides"].list.i)[1:-1]
        return sd_ops._reduce_window(i[0], k, s, n.attr["padding"].s.decode(),
                                     "max")

    def _avgpool(self, i, n):
        k = tuple(n.attr["ksize"].list.i)[1:-1]
        s = tuple(n.attr["strides"].list.i)[1:-1]
        pad = n.attr["padding"].s.decode()
        total = sd_ops._reduce_window(i[0], k, s, pad, "sum")
        if pad == "SAME":
            # TF excludes padding from the denominator at the borders
            count = sd_ops._reduce_window(torch.ones_like(i[0]), k, s, pad,
                                          "sum")
            return total / count
        return total / math.prod(k)

    # --------------------------------------------------- r4 handler methods
    def _polygamma(self, a, x):
        a = np.asarray(host_value(a)).astype(np.int32)
        x = sd_ops._fl(x)
        if a.size == 1:
            return torch.special.polygamma(int(a.reshape(-1)[0]), x)
        flat_a = np.broadcast_to(a, tuple(x.shape)).reshape(-1)
        xs = x.reshape(-1)
        return torch.stack([torch.special.polygamma(int(k), xs[j])
                            for j, k in enumerate(flat_a)]).reshape(x.shape)

    def _topk(self, i, n):
        vals, idx = sd_ops._top_k(i[0], _int(i[1]))
        return [vals, idx]

    def _segment(self, i, mode, unsorted=False):
        data = i[0]
        ids = i[1]
        if unsorted:
            num = _int(i[2])
        else:
            # num_segments = last id + 1: read from the constant ids
            num = int(np.asarray(host_value(ids)).reshape(-1)[-1]) + 1
        if mode == "mean":
            return sd_ops._seg_mean(data, ids, num)
        return {"sum": sd_ops._seg_sum, "max": sd_ops._seg_max,
                "min": sd_ops._seg_min, "prod": sd_ops._seg_prod}[mode](
            data, ids, num)

    def _bincount(self, i, n):
        w = None if i[2].numel() == 0 else i[2].reshape(-1)
        return sd_ops._bincount(i[0].reshape(-1), _int(i[1]), w)

    def _dynamic_partition(self, i, n):
        num = n.attr["num_partitions"].i
        parts = np.asarray(host_value(i[1])).astype(np.int64)
        return [i[0][torch.as_tensor(np.nonzero(parts == k)[0],
                                     device=i[0].device)]
                for k in range(num)]

    def _dynamic_stitch(self, i, n):
        half = len(i) // 2
        indices, data = i[:half], i[half:]
        idx_np = [np.asarray(host_value(ix)) for ix in indices]
        size = int(max(int(ix.max()) for ix in idx_np)) + 1
        suffix = tuple(data[0].shape[idx_np[0].ndim:])
        out = torch.zeros((size,) + suffix, dtype=data[0].dtype,
                          device=data[0].device)
        for ix, d in zip(idx_np, data):
            # each pair splits at its own index rank
            out[torch.as_tensor(ix.reshape(-1).astype(np.int64),
                                device=out.device)] = d.reshape(
                (-1,) + tuple(d.shape[ix.ndim:]))
        return out

    def _dilation2d(self, i, n):
        strides = tuple(n.attr["strides"].list.i)[1:3]
        rates = tuple(n.attr["rates"].list.i)[1:3]
        return sd_ops._dilation2d(i[0], i[1], strides, rates,
                                  n.attr["padding"].s.decode())

    def _conv3d(self, i, n):
        strides = tuple(n.attr["strides"].list.i)[1:4]
        return sd_ops._conv_general(i[0], i[1], strides,
                                    n.attr["padding"].s.decode())

    def _maxpool3d(self, i, n):
        k = tuple(n.attr["ksize"].list.i)[1:-1]
        s = tuple(n.attr["strides"].list.i)[1:-1]
        return sd_ops._reduce_window(i[0], k, s, n.attr["padding"].s.decode(),
                                     "max")

    def _avgpool3d(self, i, n):
        k = tuple(n.attr["ksize"].list.i)[1:-1]
        s = tuple(n.attr["strides"].list.i)[1:-1]
        pad = n.attr["padding"].s.decode()
        total = sd_ops._reduce_window(i[0], k, s, pad, "sum")
        if pad == "SAME":
            count = sd_ops._reduce_window(torch.ones_like(i[0]), k, s, pad,
                                          "sum")
            return total / count
        return total / math.prod(k)

    def _fake_quant_args(self, i, n):
        return sd_ops._fake_quant(
            i[0], min=_attr_f(n, "min", -6.0), max=_attr_f(n, "max", 6.0),
            num_bits=(n.attr["num_bits"].i or 8),
            narrow_range=n.attr["narrow_range"].b)

    def _check_numerics(self, i, n):
        return sd_ops._check_numerics(
            i[0], n.attr["message"].s.decode() or "CheckNumerics failed")

    def _nms_v3(self, i, n):
        idx, _ = sd_ops._nms(i[0], i[1], _int(i[2]),
                             iou_threshold=_float(i[3]),
                             score_threshold=_float(i[4]))
        return idx

    def _nms_v4(self, i, n):
        idx, count = sd_ops._nms(i[0], i[1], _int(i[2]),
                                 iou_threshold=_float(i[3]),
                                 score_threshold=_float(i[4]))
        return [idx, count]

    def _crop_and_resize(self, i, n):
        return sd_ops._crop_and_resize(
            i[0], i[1], i[2], _axes(i[3]),
            extrapolation_value=_attr_f(n, "extrapolation_value", 0.0))

    @staticmethod
    def _cubic_weights(frac, A=-0.75):
        """Keys cubic weights for taps [-1, 0, 1, 2] at offset ``frac``."""
        d = torch.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], dim=-1)
        ad = torch.abs(d)
        near = ((A + 2.0) * ad - (A + 3.0)) * ad * ad + 1.0
        far = ((A * ad - 5.0 * A) * ad + 8.0 * A) * ad - 4.0 * A
        return torch.where(ad <= 1.0, near, torch.where(ad < 2.0, far, 0.0))

    def _axis_cubic(self, n, in_dim, out_dim, dtype, device):
        """(indices (out, 4), weights (out, 4)) for one axis: legacy and
        align_corners use A=-0.75 with clamped taps; half_pixel_centers
        uses A=-0.5, out-of-range taps zeroed and the rest renormalized."""
        half = bool(n.attr["half_pixel_centers"].b)
        cs = self._resize_coords(n, in_dim, out_dim, clamp_half_pixel=False)
        c0 = torch.floor(cs)
        taps = c0.long()[:, None] + torch.arange(-1, 3)[None, :]
        wts = self._cubic_weights((cs - c0).to(dtype),
                                  A=-0.5 if half else -0.75)
        if half:
            valid = (taps >= 0) & (taps <= in_dim - 1)
            wts = wts * valid.to(dtype)
            wts = wts / torch.sum(wts, dim=-1, keepdim=True)
        return (torch.clamp(taps, 0, in_dim - 1).to(device),
                wts.to(device))

    def _resize_bicubic(self, i, n):
        x = sd_ops._fl(i[0])
        oh, ow = _axes(i[1])
        b, h, w, c = x.shape
        yi, wy = self._axis_cubic(n, h, oh, x.dtype, x.device)
        xi, wx = self._axis_cubic(n, w, ow, x.dtype, x.device)
        rows = x[:, yi]                       # (b, oh, 4, w, c)
        rows = torch.einsum("bykwc,yk->bywc", rows, wy)
        cols = rows[:, :, xi]                 # (b, oh, ow, 4, c)
        return torch.einsum("bywkc,wk->bywc", cols, wx)

    def _draw_boxes(self, i, n):
        return sd_ops._draw_bounding_boxes(
            i[0], i[1], None if len(i) < 3 or i[2].numel() == 0 else i[2])

    def _softmax_xent(self, i, n):
        logits, labels = i[0], i[1]
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.sum(labels * logp, dim=-1)
        return [loss, torch.softmax(logits, dim=-1) - labels]

    def _sparse_softmax_xent(self, i, n):
        logits = i[0]
        labels = i[1].long()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, -1, labels[..., None])[..., 0]
        grad = torch.softmax(logits, dim=-1) - F.one_hot(
            labels, logits.shape[-1]).to(logits.dtype)
        return [loss, grad]

    def _histogram_fixed_width(self, i, n):
        lo, hi = (float(v) for v in np.asarray(host_value(i[1])).reshape(-1))
        x = torch.clamp(sd_ops._fl(i[0]), lo, hi)
        return sd_ops._histogram(x, _int(i[2]), (lo, hi))

    def _multinomial(self, i, n):
        return sd_ops._multinomial(self._node_gen(n), i[0], _int(i[1]))

    def _node_gen(self, n):
        """A generator per random node, seeded by the crc32 of its name:
        the same draws every run (the reference's per-node key)."""
        return torch.Generator(device=self._device).manual_seed(
            zlib.crc32(n.name.encode()) & 0x7FFFFFFF)

    def _v1_loop_err(self, i, n):
        raise NotImplementedError(
            f"TF v1 control-flow frame op '{n.op}' (node '{n.name}'): v1 "
            "while-loops need frame analysis and are not supported; "
            "re-export the model with TF2 functional control flow "
            "(tf.function produces While/StatelessWhile, which import)")

    # ---------------------------------------------- function-library support
    def _register_functions(self, graph_def):
        for fdef in graph_def.library.function:
            self._functions[fdef.signature.name] = fdef

    @staticmethod
    def _op_output_args(op_name):
        """Output arg names of an op type (the static table)."""
        names = OUTPUT_ARGS.get(op_name)
        return list(names) if names is not None else None

    def _const(self, node):
        """A Const node's value as a tensor on the graph's device, its
        host copy remembered."""
        arr = tensor_to_numpy(node.attr["value"].tensor)
        if self._sd is not None:
            return self._sd._tensor(arr)
        return _host_tensor(arr)

    def _run_function(self, fname, args):
        """Run a FunctionDef body eagerly over tensors (the branches of
        If, the cond and body of While, PartitionedCall)."""
        fdef = self._functions[fname]
        sig = fdef.signature
        env = {}
        for arg_def, val in zip(sig.input_arg, args):
            env[arg_def.name] = val

        def resolve(ref):
            base, _, rest = ref.partition(":")
            if base.startswith("^"):
                return None
            if base in env and not rest:
                return env[base]
            v = env[base]
            if isinstance(v, dict):       # node with named output args
                arg, _, idx = rest.partition(":")
                slot = v[arg]
                return slot[int(idx)] if isinstance(slot, list) else slot
            return v

        for node in fdef.node_def:
            if node.op == "Const":
                env[node.name] = self._const(node)
                continue
            if node.op == "NoOp":
                continue
            handler = self.handlers.get(node.op)
            if handler is None:
                raise NotImplementedError(
                    f"TF op '{node.op}' inside function '{fname}' "
                    f"(node '{node.name}') not mapped")
            ins = [resolve(r) for r in node.input if not r.startswith("^")]
            out = handler(ins, node)
            if isinstance(out, list):
                names = self._op_output_args(node.op)
                if names and len(names) == len(out):
                    env[node.name] = dict(zip(names, out))
                elif names and len(names) == 1:
                    env[node.name] = {names[0]: out}  # one variadic out arg
                else:
                    raise NotImplementedError(
                        f"cannot name the {len(out)} outputs of "
                        f"'{node.op}' in function '{fname}' (not in the "
                        "output-arg table)")
            else:
                env[node.name] = out

        return [resolve(fdef.ret[o.name]) for o in sig.output_arg]

    def _if(self, i, n):
        pred, args = i[0], list(i[1:])
        branch = (n.attr["then_branch"] if bool(torch.as_tensor(
            host_value(pred)).reshape(-1)[0]) else n.attr["else_branch"])
        return list(self._run_function(branch.func.name, args))

    def _while(self, i, n):
        cond_f = n.attr["cond"].func.name
        body_f = n.attr["body"].func.name
        args = list(i)
        while bool(np.asarray(host_value(
                self._run_function(cond_f, args)[0])).reshape(-1)[0]):
            args = list(self._run_function(body_f, args))
        return args

    def _call(self, i, n):
        return self._run_function(n.attr["f"].func.name, list(i))

    # ------------------------------------------------------------------ main
    def import_graph(self, graph_def, sd: SameDiff | None = None,
                     device=None) -> SameDiff:
        """Map a GraphDef onto a SameDiff graph: the function library (V2
        control flow), multi-output ops, V1 Switch/Merge conditionals."""
        if not isinstance(graph_def, GraphDef):
            graph_def = GraphDef(_graph_bytes(graph_def))
        sd = sd or SameDiff.create(device)
        self._sd = sd
        self._device = sd.device
        self._register_functions(graph_def)
        produced: Dict[str, Any] = {}   # tf tensor name → SDVariable | list
        branch_of: Dict[str, Any] = {}
        # constant folding: nodes whose inputs are all Const evaluate here,
        # on the host, so shape/axis plumbing reaches the handlers as
        # constants
        concrete: Dict[str, Any] = {}
        _MISS = object()

        def conc_ref(name):
            base, _, idx = name.partition(":")
            v = concrete.get(base.lstrip("^"), _MISS)
            if v is _MISS:
                return _MISS
            if isinstance(v, list):
                return v[int(idx) if idx else 0]
            return v

        NOFOLD = {"RandomUniform", "RandomStandardNormal", "TruncatedNormal",
                  "RandomUniformInt", "Multinomial", "Switch", "Merge",
                  "If", "StatelessIf", "While", "StatelessWhile",
                  "PartitionedCall", "StatefulPartitionedCall"}

        def tensor_ref(name) -> SDVariable:
            base, _, idx = name.partition(":")
            base = base.lstrip("^")
            v = produced[base]
            if isinstance(v, list):
                return v[int(idx) if idx else 0]
            return v

        for node in graph_def.node:
            op = node.op
            if op == "Const":
                arr = tensor_to_numpy(node.attr["value"].tensor)
                concrete[node.name] = arr
                produced[node.name] = sd.constant(node.name, arr)
                continue
            if op in ("Placeholder", "PlaceholderWithDefault"):
                shape = None
                if node.attr["shape"].shape.dim:
                    shape = tuple(d.size if d.size > 0 else None
                                  for d in node.attr["shape"].shape.dim)
                produced[node.name] = sd.placeholder(node.name, shape)
                continue
            if op == "NoOp":
                continue
            if op in ("Enter", "Exit", "NextIteration", "LoopCond"):
                self._v1_loop_err(None, node)   # fail at import, not eval
            data_inputs = [i for i in node.input if not i.startswith("^")]
            if op == "Switch":
                # outputs 0 (false) and 1 (true) are both views of the
                # data; Merge selects
                data = tensor_ref(data_inputs[0])
                pred_name = data_inputs[1]
                outs = [sd._op(f"{node.name}_b{j}", lambda t: t, [data])
                        for j in range(2)]
                branch_of[f"{node.name}:0"] = (pred_name, False)
                branch_of[f"{node.name}:1"] = (pred_name, True)
                branch_of[node.name] = (pred_name, False)
                produced[node.name] = outs
                continue
            if op == "Merge":
                infos = [branch_of.get(i) for i in data_inputs]
                if not any(infos):
                    raise NotImplementedError(
                        f"Merge '{node.name}' without Switch ancestry "
                        "(v1 loop?) is not supported")
                pred_name = next(inf[0] for inf in infos if inf)
                pred = tensor_ref(pred_name)
                vals = [tensor_ref(i) for i in data_inputs]
                true_pos = next(
                    (k for k, inf in enumerate(infos) if inf and inf[1]),
                    None)
                if true_pos is None or len(vals) != 2:
                    raise NotImplementedError(
                        f"Merge '{node.name}': cannot identify the "
                        "true-branch input from Switch lineage "
                        f"({len(vals)} inputs, lineage {infos}) — silently "
                        "guessing would invert the conditional")
                t_val = vals[true_pos]
                f_val = vals[1 - true_pos]
                v = sd._op(node.name + "_op",
                           lambda f, t, p: torch.where(p.bool(), t, f),
                           [f_val, t_val, pred])
                v.rename(node.name)
                # value_index = position of the chosen input (TF contract)
                vi = sd._op(node.name + "_index",
                            (lambda tp: lambda p: torch.where(
                                p.bool(), tp, 1 - tp).to(torch.int32))(
                                true_pos), [pred])
                produced[node.name] = [v, vi]
                outer = branch_of.get(pred_name)
                if outer is not None:
                    branch_of[node.name] = outer
                    branch_of[node.name + ":0"] = outer
                continue
            handler = self.handlers.get(op)
            if handler is None:
                raise NotImplementedError(
                    f"TF op '{op}' (node '{node.name}') not mapped; "
                    f"supported: {sorted(k for k, v in self.handlers.items() if v)}")

            conc_ins = [conc_ref(i) for i in data_inputs]
            if op not in NOFOLD and all(v is not _MISS for v in conc_ins):
                out = handler([_host_tensor(v) for v in conc_ins], node)
                if isinstance(out, list):
                    concrete[node.name] = [_numpy(v) for v in out]
                    produced[node.name] = [
                        sd.constant(f"{node.name}_{j}", _numpy(v))
                        for j, v in enumerate(out)]
                else:
                    concrete[node.name] = _numpy(out)
                    produced[node.name] = sd.constant(node.name,
                                                      _numpy(out))
                continue
            ins = [tensor_ref(i) for i in data_inputs]
            host = op in _HOST_OPS or any(
                conc_ins[p] is _MISS for p in _STATIC.get(op, ())
                if -len(conc_ins) <= p < len(conc_ins))
            if op in ("DynamicStitch", "ParallelDynamicStitch"):
                host = host or any(v is _MISS
                                   for v in conc_ins[:len(conc_ins) // 2])

            def make_fn(h=handler, nd=node):
                def fn(*vals):
                    return h(list(vals), nd)
                return fn

            lineage = next((branch_of[i] for i in data_inputs
                            if i in branch_of), None)
            if lineage is not None:
                branch_of[node.name] = lineage
                branch_of[node.name + ":0"] = lineage

            if op in self.multi_output:
                count = int(self.multi_output[op](node))
                tup = sd._op(node.name + "_tuple", make_fn(), ins, host=host)
                outs = []
                for j in range(count):
                    outs.append(sd._op(f"{node.name}_{j}",
                                       (lambda jj: lambda t: t[jj])(j),
                                       [tup]))
                    if lineage is not None:
                        branch_of[f"{node.name}:{j}"] = lineage
                produced[node.name] = outs
            else:
                v = sd._op(node.name + "_op", make_fn(), ins, host=host)
                v.rename(node.name)
                produced[node.name] = v
        return sd


def _getitem(x, idx):
    """``x[idx]`` with numpy's negative-stride slices (torch has none)."""
    if not any(isinstance(s, slice) and s.step is not None and s.step < 0
               for s in idx):
        return x[tuple(idx)]
    out_idx, d = [], 0
    n_real = sum(1 for s in idx if s is not None and s is not Ellipsis)
    for s in idx:
        if s is Ellipsis:
            skip = x.ndim - n_real
            out_idx += [slice(None)] * skip
            d += skip
        elif s is None:
            out_idx.append(None)
        elif isinstance(s, slice) and s.step is not None and s.step < 0:
            r = list(range(x.shape[d]))[s]
            out_idx.append(sd_ops._t(np.asarray(r, np.int64)).to(
                x.device).long())
            d += 1
        else:
            out_idx.append(s)
            d += 1
    out = x
    dim = 0
    for s in out_idx:
        if s is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(s, torch.Tensor):
            out = out.index_select(dim, s)
            dim += 1
        elif isinstance(s, slice):
            out = out[(slice(None),) * dim + (s,)]
            dim += 1
        else:
            out = out.select(dim, s)
    return out


def _int_vector(v, device):
    """A shape, a rank or a size as an int32 tensor with its host copy."""
    arr = np.asarray(v, dtype=np.int32)
    t = sd_ops._t(arr)
    return set_host_value(t if device is None else t.to(device), arr)


def _host_tensor(arr):
    """A numpy value as a CPU tensor in the reference's 32-bit types,
    with its host copy."""
    if isinstance(arr, np.ndarray) and arr.dtype == object:
        raise NotImplementedError("string tensors are not supported")
    t = sd_ops._t(arr)
    return set_host_value(t, t.numpy())


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _graph_bytes(src) -> bytes:
    """A serialized GraphDef from a path, bytes, or an object with
    ``SerializeToString()`` (a TF ``GraphDef``)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    if hasattr(src, "SerializeToString"):
        return src.SerializeToString()
    raise TypeError(f"cannot read a GraphDef from {type(src).__name__}")


def import_frozen_graph(path_or_graphdef, outputs: List[str] | None = None,
                        device=None):
    """Load a frozen GraphDef (a path, serialized bytes, or an object with
    ``SerializeToString()``) → (SameDiff, outputs)."""
    sd = TFImporter().import_graph(path_or_graphdef, device=device)
    outs = [sd.get_variable(o) for o in outputs] if outputs else None
    return sd, outs
