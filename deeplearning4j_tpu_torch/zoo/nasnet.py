"""NASNet-A (mobile) — port of ``deeplearning4j_tpu/zoo/nasnet.py``
(``org.deeplearning4j.zoo.model.NASNet``): a stem conv, two stem
reduction cells, then 3 stacks of normal cells separated by reduction
cells, penultimate 1056 filters. Each branch's separable conv is one
relu → sep-conv → BN unit, as in the reference.
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
from ..nn.layers.core import ActivationLayer, OutputLayer
from ..nn.layers.norm import BatchNormalization
from ..nn.vertices import ElementWiseVertex, MergeVertex
from ..train.updaters import Adam
from .base import ZooModel


@dataclass
class NASNet(ZooModel):
    num_classes: int = 1000
    input_shape: Tuple = (224, 224, 3)
    stem_filters: int = 32
    penultimate_filters: int = 1056
    cells_per_stack: int = 4

    def conf(self):
        b = NeuralNetConfiguration.builder().seed(self.seed)
        b.updater(self.updater or Adam(1e-3))
        if self.compute_dtype is not None:
            b.data_type(torch.float32, self.compute_dtype)
        g = b.graph_builder().add_inputs("in")
        uid = [0]

        def nm(p):
            uid[0] += 1
            return f"{p}{uid[0]}"

        def conv_bn(inp, n, k=1, stride=1, act=None):
            name = nm("cb")
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n, kernel_size=(k, k), stride=(stride, stride),
                convolution_mode="same", activation="identity",
                has_bias=False), inp)
            g.add_layer(f"{name}_b", BatchNormalization(), f"{name}_c")
            if act is None:
                return f"{name}_b"
            g.add_layer(name, ActivationLayer(activation=act), f"{name}_b")
            return name

        def sep(inp, n, k, stride=1):
            """relu → separable kxk → BN (NASNet branch unit)."""
            name = nm("sep")
            g.add_layer(f"{name}_a", ActivationLayer(activation="relu"), inp)
            g.add_layer(f"{name}_s", SeparableConvolution2D(
                n_out=n, kernel_size=(k, k), stride=(stride, stride),
                convolution_mode="same", activation="identity",
                has_bias=False), f"{name}_a")
            g.add_layer(name, BatchNormalization(), f"{name}_s")
            return name

        def pool(inp, kind, stride):
            name = nm("pool")
            g.add_layer(name, SubsamplingLayer(
                kernel_size=(3, 3), stride=(stride, stride),
                pooling_type=kind, convolution_mode="same"), inp)
            return name

        def add(a, b_):
            name = nm("add")
            g.add_vertex(name, ElementWiseVertex(op="add"), a, b_)
            return name

        def cat(*ins):
            name = nm("cat")
            g.add_vertex(name, MergeVertex(), *ins)
            return name

        def adjust(p, p_level, h_level, f):
            """Bring the skip input to the working resolution (reference:
            factorized reduction in the NASNet adjust block)."""
            for _ in range(h_level - p_level):
                p = conv_bn(p, f, 1, stride=2, act="relu")
            return p

        def normal_cell(p, h, f):
            p = conv_bn(p, f, 1)
            h = conv_bn(h, f, 1)
            x1 = add(sep(h, f, 5), sep(p, f, 3))
            x2 = add(sep(p, f, 5), sep(p, f, 3))
            x3 = add(pool(h, "avg", 1), p)
            x4 = add(pool(p, "avg", 1), pool(p, "avg", 1))
            x5 = add(sep(h, f, 3), h)
            return cat(p, x1, x2, x3, x4, x5)

        def reduction_cell(p, h, f):
            p = conv_bn(p, f, 1)
            h = conv_bn(h, f, 1)
            x1 = add(sep(h, f, 5, 2), sep(p, f, 7, 2))
            x2 = add(pool(h, "max", 2), sep(p, f, 7, 2))
            x3 = add(pool(h, "avg", 2), sep(p, f, 5, 2))
            x4 = add(pool(x1, "avg", 1), x2)
            x5 = add(sep(x1, f, 3), pool(h, "max", 2))
            return cat(x2, x3, x4, x5)

        # filters per stack: penultimate/24 (normal-cell concat = 6 branches
        # over 3 stacks with x2 per reduction): mobile → 44, 88, 176
        f = self.penultimate_filters // 24
        x = conv_bn("in", self.stem_filters, 3, stride=2)
        p, p_lv, x_lv = x, 1, 1
        # stem reductions to 1/8 resolution (reference stem has 2 reduction cells)
        for sf in (max(f // 2, 1), f):
            pa = adjust(p, p_lv, x_lv, sf)
            x_new = reduction_cell(pa, x, sf)
            p, p_lv, x, x_lv = x, x_lv, x_new, x_lv + 1
        for stack in range(3):
            if stack > 0:
                pa = adjust(p, p_lv, x_lv, f)
                x_new = reduction_cell(pa, x, f)
                p, p_lv, x, x_lv = x, x_lv, x_new, x_lv + 1
            for _ in range(self.cells_per_stack):
                pa = adjust(p, p_lv, x_lv, f)
                x_new = normal_cell(pa, x, f)
                p, p_lv, x, x_lv = x, x_lv, x_new, x_lv
            f *= 2
        g.add_layer("final_act", ActivationLayer(activation="relu"), x)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "final_act")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)
