"""Sequential zoo models — port of the part of
``deeplearning4j_tpu/zoo/cnn_simple.py`` slice 4 runs: ``LeNet`` and
``TextGenerationLSTM`` (the char-RNN), both ``MultiLayerNetwork``s.
Layout is NHWC / NTC as in the reference; compute can be bf16 through
``compute_dtype``.

Not ported yet: SimpleCNN, AlexNet, VGG16, VGG19, Darknet19, SqueezeNet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType
from ..nn.layers.conv import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.core import DenseLayer, OutputLayer, RnnOutputLayer
from ..nn.layers.recurrent import GravesLSTM
from ..nn.multi_layer_network import MultiLayerNetwork
from ..train.updaters import Adam
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
