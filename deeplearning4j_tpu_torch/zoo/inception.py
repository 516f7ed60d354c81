"""Inception-family zoo models — port of ``deeplearning4j_tpu/zoo/
inception.py``: Xception, InceptionResNetV1, FaceNetNN4Small2
(``org.deeplearning4j.zoo.model``), ComputationGraphs in NHWC; optional
bf16 compute through ``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn.computation_graph import ComputationGraph
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType
from ..nn.layers.conv import (ConvolutionLayer, GlobalPoolingLayer,
                              SeparableConvolution2D, SubsamplingLayer)
from ..nn.layers.core import (ActivationLayer, CenterLossOutputLayer,
                              DenseLayer, DropoutLayer, OutputLayer)
from ..nn.layers.norm import BatchNormalization
from ..nn.vertices import ElementWiseVertex, L2NormalizeVertex, MergeVertex, ScaleVertex
from ..train.updaters import Adam
from .base import ZooModel


def _graph(seed, updater, compute_dtype, default_lr=1e-3):
    b = NeuralNetConfiguration.builder().seed(seed)
    b.updater(updater or Adam(default_lr))
    if compute_dtype is not None:
        b.data_type(torch.float32, compute_dtype)
    return b.graph_builder().add_inputs("in")


class _G:
    """Small helper for building conv-heavy graphs with unique names."""

    def __init__(self, g):
        self.g = g
        self.i = 0

    def conv_bn(self, inp, n, k, stride=1, act="relu", name=None):
        name = name or f"cv{self.i}"
        self.i += 1
        self.g.add_layer(f"{name}_c", ConvolutionLayer(
            n_out=n, kernel_size=(k, k) if isinstance(k, int) else k,
            stride=(stride, stride), convolution_mode="same",
            activation="identity", has_bias=False), inp)
        self.g.add_layer(f"{name}_b", BatchNormalization(), f"{name}_c")
        if act is None:
            return f"{name}_b"
        self.g.add_layer(name, ActivationLayer(activation=act), f"{name}_b")
        return name

    def sep_bn(self, inp, n, act="relu", pre_act=False, name=None):
        name = name or f"sp{self.i}"
        self.i += 1
        src = inp
        if pre_act:
            self.g.add_layer(f"{name}_pre", ActivationLayer(activation="relu"), src)
            src = f"{name}_pre"
        self.g.add_layer(f"{name}_s", SeparableConvolution2D(
            n_out=n, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), src)
        self.g.add_layer(f"{name}_b" if act is None else f"{name}_bn",
                         BatchNormalization(), f"{name}_s")
        if act is None:
            return f"{name}_b"
        self.g.add_layer(name, ActivationLayer(activation=act), f"{name}_bn")
        return name

    def pool(self, inp, k=3, stride=2, kind="max", name=None):
        name = name or f"pl{self.i}"
        self.i += 1
        self.g.add_layer(name, SubsamplingLayer(
            kernel_size=(k, k), stride=(stride, stride), pooling_type=kind,
            convolution_mode="same"), inp)
        return name

    def add(self, a, b, name=None):
        name = name or f"ad{self.i}"
        self.i += 1
        self.g.add_vertex(name, ElementWiseVertex(op="add"), a, b)
        return name

    def cat(self, name, *ins):
        self.g.add_vertex(name, MergeVertex(), *ins)
        return name


@dataclass
class Xception(ZooModel):
    """Xception: depthwise-separable Inception redesign (entry/middle/exit
    flows with residuals). Reference Xception; 299x299x3."""

    num_classes: int = 1000
    input_shape: Tuple = (299, 299, 3)

    def conf(self):
        g = _graph(self.seed, self.updater, self.compute_dtype)
        G = _G(g)
        # entry flow
        x = G.conv_bn("in", 32, 3, stride=2)
        x = G.conv_bn(x, 64, 3)
        for n in (128, 256, 728):
            res = G.conv_bn(x, n, 1, stride=2, act=None)
            y = G.sep_bn(x, n, act=None, pre_act=(n != 128))
            if n == 128:
                g.add_layer(f"eact{n}", ActivationLayer(activation="relu"), y)
                y = f"eact{n}"
                y = G.sep_bn(y, n, act=None)
            else:
                y = G.sep_bn(y, n, act=None, pre_act=True)
            y = G.pool(y)
            x = G.add(y, res)
        # middle flow: 8 residual blocks of 3 separable convs
        for i in range(8):
            y = x
            for j in range(3):
                y = G.sep_bn(y, 728, act=None, pre_act=True)
            x = G.add(y, x)
        # exit flow
        res = G.conv_bn(x, 1024, 1, stride=2, act=None)
        y = G.sep_bn(x, 728, act=None, pre_act=True)
        y = G.sep_bn(y, 1024, act=None, pre_act=True)
        y = G.pool(y)
        x = G.add(y, res)
        x = G.sep_bn(x, 1536)
        x = G.sep_bn(x, 2048)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("out", OutputLayer(n_in=2048, n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)


@dataclass
class InceptionResNetV1(ZooModel):
    """Inception-ResNet-v1 (FaceNet backbone): stem + 5xA + reduction-A +
    10xB + reduction-B + 5xC + 128-d bottleneck. Reference
    InceptionResNetV1 (embedding + softmax training head)."""

    num_classes: int = 1000
    input_shape: Tuple = (160, 160, 3)
    embedding_size: int = 128
    blocks_a: int = 5
    blocks_b: int = 10
    blocks_c: int = 5

    def conf(self):
        g = _graph(self.seed, self.updater, self.compute_dtype, 1e-1)
        G = _G(g)
        # stem
        x = G.conv_bn("in", 32, 3, stride=2)
        x = G.conv_bn(x, 32, 3)
        x = G.conv_bn(x, 64, 3)
        x = G.pool(x)
        x = G.conv_bn(x, 80, 1)
        x = G.conv_bn(x, 192, 3)
        x = G.conv_bn(x, 256, 3, stride=2)

        def block_a(x, i):
            b0 = G.conv_bn(x, 32, 1)
            b1 = G.conv_bn(G.conv_bn(x, 32, 1), 32, 3)
            b2 = G.conv_bn(G.conv_bn(G.conv_bn(x, 32, 1), 32, 3), 32, 3)
            cat = G.cat(f"a{i}_cat", b0, b1, b2)
            up = G.conv_bn(cat, 256, 1, act=None)
            g.add_vertex(f"a{i}_scale", ScaleVertex(scale=0.17), up)
            s = G.add(x, f"a{i}_scale")
            g.add_layer(f"a{i}", ActivationLayer(activation="relu"), s)
            return f"a{i}"

        def block_b(x, i):
            b0 = G.conv_bn(x, 128, 1)
            b1 = G.conv_bn(G.conv_bn(G.conv_bn(x, 128, 1), 128, (1, 7)), 128, (7, 1))
            cat = G.cat(f"b{i}_cat", b0, b1)
            up = G.conv_bn(cat, 896, 1, act=None)
            g.add_vertex(f"b{i}_scale", ScaleVertex(scale=0.10), up)
            s = G.add(x, f"b{i}_scale")
            g.add_layer(f"b{i}", ActivationLayer(activation="relu"), s)
            return f"b{i}"

        def block_c(x, i):
            b0 = G.conv_bn(x, 192, 1)
            b1 = G.conv_bn(G.conv_bn(G.conv_bn(x, 192, 1), 192, (1, 3)), 192, (3, 1))
            cat = G.cat(f"c{i}_cat", b0, b1)
            up = G.conv_bn(cat, 1792, 1, act=None)
            g.add_vertex(f"c{i}_scale", ScaleVertex(scale=0.20), up)
            s = G.add(x, f"c{i}_scale")
            g.add_layer(f"c{i}", ActivationLayer(activation="relu"), s)
            return f"c{i}"

        for i in range(self.blocks_a):
            x = block_a(x, i)
        # reduction-A → 896ch
        ra0 = G.pool(x)
        ra1 = G.conv_bn(x, 384, 3, stride=2)
        ra2 = G.conv_bn(G.conv_bn(G.conv_bn(x, 192, 1), 192, 3), 256, 3, stride=2)
        x = G.cat("redA", ra0, ra1, ra2)
        for i in range(self.blocks_b):
            x = block_b(x, i)
        # reduction-B → 1792ch
        rb0 = G.pool(x)
        rb1 = G.conv_bn(G.conv_bn(x, 256, 1), 384, 3, stride=2)
        rb2 = G.conv_bn(G.conv_bn(x, 256, 1), 256, 3, stride=2)
        rb3 = G.conv_bn(G.conv_bn(G.conv_bn(x, 256, 1), 256, 3), 256, 3, stride=2)
        x = G.cat("redB", rb0, rb1, rb2, rb3)
        for i in range(self.blocks_c):
            x = block_c(x, i)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("drop", DropoutLayer(rate=0.2), "gap")
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "drop")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", OutputLayer(n_in=self.embedding_size,
                                       n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "embeddings")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)


@dataclass
class FaceNetNN4Small2(ZooModel):
    """FaceNet NN4-small2: GoogLeNet-style inception modules + 128-d
    L2-normalised embedding + center-loss softmax head (reference
    FaceNetNN4Small2, FaceNetHelper inception blocks)."""

    num_classes: int = 1000
    input_shape: Tuple = (96, 96, 3)
    embedding_size: int = 128

    def conf(self):
        g = _graph(self.seed, self.updater, self.compute_dtype, 1e-1)
        G = _G(g)

        def inception(name, inp, c1, c3r, c3, c5r, c5, pp):
            """1x1 + (1x1→3x3) + (1x1→5x5) + (pool→1x1proj) merge."""
            branches = []
            if c1:
                branches.append(G.conv_bn(inp, c1, 1, name=f"{name}_1x1"))
            b3 = G.conv_bn(inp, c3r, 1, name=f"{name}_3r")
            branches.append(G.conv_bn(b3, c3, 3, name=f"{name}_3x3"))
            if c5r:
                b5 = G.conv_bn(inp, c5r, 1, name=f"{name}_5r")
                branches.append(G.conv_bn(b5, c5, 5, name=f"{name}_5x5"))
            p = G.pool(inp, k=3, stride=1, name=f"{name}_pool")
            if pp:
                branches.append(G.conv_bn(p, pp, 1, name=f"{name}_pp"))
            else:
                branches.append(p)
            return G.cat(name, *branches)

        x = G.conv_bn("in", 64, 7, stride=2)
        x = G.pool(x)
        x = G.conv_bn(x, 64, 1)
        x = G.conv_bn(x, 192, 3)
        x = G.pool(x)
        x = inception("3a", x, 64, 96, 128, 16, 32, 32)
        x = inception("3b", x, 64, 96, 128, 32, 64, 64)
        x = G.pool(x)
        x = inception("4a", x, 256, 96, 192, 32, 64, 128)
        x = inception("4e", x, 0, 160, 256, 64, 128, 0)
        x = G.pool(x)
        x = inception("5a", x, 256, 96, 384, 0, 0, 96)
        x = inception("5b", x, 256, 96, 384, 0, 0, 96)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "gap")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_in=self.embedding_size, n_out=self.num_classes,
            activation="softmax", loss="mcxent", alpha=0.9, lambda_=2e-4),
            "embeddings")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)
