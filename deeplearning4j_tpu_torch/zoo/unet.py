"""UNet — port of ``deeplearning4j_tpu/zoo/unet.py``
(``org.deeplearning4j.zoo.model.UNet``): 512×512×3 input, double-conv
blocks 64..1024, an up-conv decoder with merged skips, a 1×1 conv and a
per-pixel binary cross-entropy through ``CnnLossLayer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn.computation_graph import ComputationGraph
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType
from ..nn.layers.conv import (ConvolutionLayer, SubsamplingLayer, Upsampling2D)
from ..nn.layers.core import CnnLossLayer
from ..nn.vertices import MergeVertex
from ..train.updaters import Adam
from .base import ZooModel


@dataclass
class UNet(ZooModel):
    num_classes: int = 1                 # binary mask (reference UNet)
    input_shape: Tuple = (512, 512, 3)

    def conf(self):
        b = NeuralNetConfiguration.builder().seed(self.seed)
        b.updater(self.updater or Adam(1e-4))
        if self.compute_dtype is not None:
            b.data_type(torch.float32, self.compute_dtype)
        g = b.graph_builder().add_inputs("in")

        def double_conv(name, inp, n):
            g.add_layer(f"{name}_1", ConvolutionLayer(
                n_out=n, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), inp)
            g.add_layer(f"{name}_2", ConvolutionLayer(
                n_out=n, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), f"{name}_1")
            return f"{name}_2"

        # encoder
        skips = []
        x = "in"
        for i, n in enumerate((64, 128, 256, 512)):
            x = double_conv(f"enc{i}", x, n)
            skips.append(x)
            g.add_layer(f"pool{i}", SubsamplingLayer(kernel_size=(2, 2),
                                                     stride=(2, 2)), x)
            x = f"pool{i}"
        x = double_conv("bottom", x, 1024)

        # decoder: upsample + 2x2 conv ("up-conv"), concat skip, double conv
        for i, n in zip(range(3, -1, -1), (512, 256, 128, 64)):
            g.add_layer(f"up{i}_us", Upsampling2D(size=2), x)
            g.add_layer(f"up{i}_conv", ConvolutionLayer(
                n_out=n, kernel_size=(2, 2), convolution_mode="same",
                activation="relu"), f"up{i}_us")
            g.add_vertex(f"cat{i}", MergeVertex(), skips[i], f"up{i}_conv")
            x = double_conv(f"dec{i}", f"cat{i}", n)

        g.add_layer("head", ConvolutionLayer(n_out=2, kernel_size=(3, 3),
                                             convolution_mode="same",
                                             activation="relu"), x)
        g.add_layer("mask", ConvolutionLayer(n_out=self.num_classes,
                                             kernel_size=(1, 1),
                                             convolution_mode="same",
                                             activation="identity"), "head")
        g.add_layer("out", CnnLossLayer(activation="sigmoid", loss="binary_xent"),
                    "mask")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)
