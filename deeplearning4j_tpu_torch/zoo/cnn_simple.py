"""Sequential CNN zoo models — port of ``deeplearning4j_tpu/zoo/
cnn_simple.py``: ``LeNet``, ``SimpleCNN``, ``AlexNet``, ``VGG16``,
``VGG19``, ``Darknet19``, ``SqueezeNet`` (a ComputationGraph: its fire
modules merge branches) and ``TextGenerationLSTM`` (the char-RNN).
Layout is NHWC / NTC as in the reference; compute can be bf16 through
``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn.computation_graph import ComputationGraph
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType
from ..nn.layers.conv import (ConvolutionLayer, GlobalPoolingLayer,
                              SubsamplingLayer)
from ..nn.layers.core import (ActivationLayer, DenseLayer, DropoutLayer,
                              OutputLayer, RnnOutputLayer)
from ..nn.layers.norm import BatchNormalization, LocalResponseNormalization
from ..nn.layers.recurrent import GravesLSTM
from ..nn.multi_layer_network import MultiLayerNetwork
from ..nn.vertices import MergeVertex
from ..train.updaters import Adam, Nesterovs
from .base import ZooModel


def _builder(seed, updater, compute_dtype):
    b = NeuralNetConfiguration.builder().seed(seed)
    b.updater(updater or Adam(1e-3))
    if compute_dtype is not None:
        b.data_type(torch.float32, compute_dtype)
    return b


@dataclass
class LeNet(ZooModel):
    """LeNet-5: 2x(conv5x5 + maxpool) + fc500 + softmax (reference LeNet)."""

    num_classes: int = 10
    input_shape: Tuple = (28, 28, 1)

    def conf(self):
        return (_builder(self.seed, self.updater, self.compute_dtype)
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(*self.input_shape))
                .build())

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


@dataclass
class SimpleCNN(ZooModel):
    """4-block CNN (reference SimpleCNN)."""

    num_classes: int = 10
    input_shape: Tuple = (48, 48, 3)

    def conf(self):
        b = (_builder(self.seed, self.updater, self.compute_dtype).list())
        for n_out in (16, 32, 64, 128):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     convolution_mode="same", activation="identity"))
            b.layer(BatchNormalization())
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     convolution_mode="same", activation="relu"))
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(DenseLayer(n_out=256, activation="relu"))
        b.layer(DropoutLayer(rate=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


@dataclass
class AlexNet(ZooModel):
    """AlexNet with LRN (reference AlexNet)."""

    num_classes: int = 1000
    input_shape: Tuple = (224, 224, 3)

    def conf(self):
        return (_builder(self.seed, self.updater or Nesterovs(1e-2, 0.9),
                         self.compute_dtype)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                        convolution_mode="truncate", padding=2,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        convolution_mode="same", activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(*self.input_shape))
                .build())

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


def _vgg_blocks(b, cfg):
    for item in cfg:
        if item == "M":
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        else:
            b.layer(ConvolutionLayer(n_out=item, kernel_size=(3, 3),
                                     convolution_mode="same", activation="relu"))
    return b


@dataclass
class VGG16(ZooModel):
    num_classes: int = 1000
    input_shape: Tuple = (224, 224, 3)

    _CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M")

    def conf(self):
        b = _builder(self.seed, self.updater or Nesterovs(1e-2, 0.9),
                     self.compute_dtype).list()
        _vgg_blocks(b, self._CFG)
        b.layer(DenseLayer(n_out=4096, activation="relu"))
        b.layer(DropoutLayer(rate=0.5))
        b.layer(DenseLayer(n_out=4096, activation="relu"))
        b.layer(DropoutLayer(rate=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


@dataclass
class VGG19(VGG16):
    _CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


@dataclass
class Darknet19(ZooModel):
    """Darknet-19 classifier backbone (reference Darknet19)."""

    num_classes: int = 1000
    input_shape: Tuple = (224, 224, 3)

    def conf(self):
        b = _builder(self.seed, self.updater, self.compute_dtype).list()

        def conv_bn(n, k):
            b.layer(ConvolutionLayer(n_out=n, kernel_size=(k, k),
                                     convolution_mode="same", activation="identity",
                                     has_bias=False))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="leakyrelu"))

        conv_bn(32, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        conv_bn(64, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for trio in ((128, 64, 128), (256, 128, 256)):
            conv_bn(trio[0], 3)
            conv_bn(trio[1], 1)
            conv_bn(trio[2], 3)
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        conv_bn(512, 3)
        conv_bn(256, 1)
        conv_bn(512, 3)
        conv_bn(256, 1)
        conv_bn(512, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        conv_bn(1024, 3)
        conv_bn(512, 1)
        conv_bn(1024, 3)
        conv_bn(512, 1)
        conv_bn(1024, 3)
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                 convolution_mode="same", activation="identity"))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_in=self.num_classes, n_out=self.num_classes,
                            activation="softmax", loss="mcxent"))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


@dataclass
class SqueezeNet(ZooModel):
    """SqueezeNet v1.1 (fire modules) — built as a ComputationGraph since
    fire modules merge squeeze/expand branches."""

    num_classes: int = 1000
    input_shape: Tuple = (227, 227, 3)

    def conf(self):
        g = (_builder(self.seed, self.updater, self.compute_dtype)
             .graph_builder()
             .add_inputs("in"))
        g.add_layer("conv1", ConvolutionLayer(n_out=64, kernel_size=(3, 3), stride=(2, 2),
                                              convolution_mode="same", activation="relu"), "in")
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), "conv1")
        prev = "pool1"

        def fire(name, squeeze, expand, inp):
            g.add_layer(f"{name}_s", ConvolutionLayer(n_out=squeeze, kernel_size=(1, 1),
                                                      convolution_mode="same",
                                                      activation="relu"), inp)
            g.add_layer(f"{name}_e1", ConvolutionLayer(n_out=expand, kernel_size=(1, 1),
                                                       convolution_mode="same",
                                                       activation="relu"), f"{name}_s")
            g.add_layer(f"{name}_e3", ConvolutionLayer(n_out=expand, kernel_size=(3, 3),
                                                       convolution_mode="same",
                                                       activation="relu"), f"{name}_s")
            g.add_vertex(name, MergeVertex(), f"{name}_e1", f"{name}_e3")
            return name

        prev = fire("fire2", 16, 64, prev)
        prev = fire("fire3", 16, 64, prev)
        g.add_layer("pool3", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), prev)
        prev = fire("fire4", 32, 128, "pool3")
        prev = fire("fire5", 32, 128, prev)
        g.add_layer("pool5", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), prev)
        prev = fire("fire6", 48, 192, "pool5")
        prev = fire("fire7", 48, 192, prev)
        prev = fire("fire8", 64, 256, prev)
        prev = fire("fire9", 64, 256, prev)
        g.add_layer("drop", DropoutLayer(rate=0.5), prev)
        g.add_layer("conv10", ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                               convolution_mode="same", activation="relu"),
                    "drop")
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "conv10")
        g.add_layer("out", OutputLayer(n_in=self.num_classes, n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)


@dataclass
class TextGenerationLSTM(ZooModel):
    """Char-RNN: 2xGravesLSTM + RnnOutput (reference TextGenerationLSTM)."""

    num_classes: int = 77          # vocab
    input_shape: Tuple = (60, 77)  # (T, vocab) NTC
    units: int = 256

    def conf(self):
        return (_builder(self.seed, self.updater, self.compute_dtype)
                .list()
                .layer(GravesLSTM(n_in=self.input_shape[1], n_out=self.units))
                .layer(GravesLSTM(n_in=self.units, n_out=self.units))
                .layer(RnnOutputLayer(n_in=self.units, n_out=self.num_classes,
                                      activation="softmax", loss="mcxent"))
                .build())

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(self.input_shape,
                                                   device=device)

    def generate(self, net, seed, n_steps, temperature: float = 1.0,
                 generator=None):
        """Sample ``n_steps`` tokens after priming on ``seed`` (B, T, vocab)
        one-hot — the reference example's sampleCharactersFromNetwork,
        one streamed ``rnn_time_step`` per sampled char. ``generator``: a
        ``torch.Generator`` on the net's device (default seeded with 0).
        Returns int32 token ids (B, n_steps)."""
        if generator is None:
            generator = torch.Generator(device=net.device).manual_seed(0)
        net.rnn_clear_previous_state()
        probs = net.rnn_time_step(seed)[:, -1]              # prime on seed
        tokens = []
        for _ in range(n_steps):
            logits = torch.log(torch.clamp(probs.float(), min=1e-9)) \
                / temperature
            tok = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
            tokens.append(tok)
            probs = net.rnn_time_step(torch.nn.functional.one_hot(
                tok, self.num_classes).float())
        return torch.stack(tokens, dim=1).to(torch.int32)
