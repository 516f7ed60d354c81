"""ResNet-50 — port of ``deeplearning4j_tpu/zoo/resnet.py``
(``org.deeplearning4j.zoo.model.ResNet50``, an ImageNet ComputationGraph).

NHWC activations, identity/projection bottleneck blocks as graph
vertices, every conv followed by a BatchNormalization that carries the
activation (relu, or identity before the residual add): 53 BN layers, 33
of them with relu. With ``compute_dtype=torch.bfloat16`` params stay f32
and the convs run in bf16; the BNs keep the conv's bf16, compute in f32
and store bf16 — on the card through the fused K3 kernels when ``fused``
engages (``nn/layers/norm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn.computation_graph import ComputationGraph
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers.base import InputType
from ..nn.layers.conv import (ConvolutionLayer, GlobalPoolingLayer,
                              SpaceToDepthLayer, SubsamplingLayer)
from ..nn.layers.core import ActivationLayer, OutputLayer
from ..nn.layers.norm import BatchNormalization
from ..nn.vertices import ElementWiseVertex
from ..train.updaters import Adam
from .base import ZooModel


@dataclass
class ResNet50(ZooModel):
    num_classes: int = 1000
    input_shape: Tuple = (224, 224, 3)
    # MLPerf-style stem: space-to-depth(2) of the input and the EXACTLY
    # equivalent 4x4/s1 conv on 12 channels in place of the 7x7/s2 stem
    # (weights folded by `fold_stem_weights_s2d`)
    stem_space_to_depth: bool = False
    # n: the train-time forward runs as n checkpoint segments cut at
    # block boundaries (ComputationGraph.remat_segments); None: monolithic
    remat_segments: "int | None" = None

    # (n_blocks, filters) per stage; first block of stages 2-4 downsamples
    STAGES = ((3, (64, 64, 256)), (4, (128, 128, 512)),
              (6, (256, 256, 1024)), (3, (512, 512, 2048)))

    def conf(self):
        b = NeuralNetConfiguration.builder().seed(self.seed)
        b.updater(self.updater or Adam(1e-3))
        if self.compute_dtype is not None:
            b.data_type(torch.float32, self.compute_dtype)
        g = b.graph_builder().add_inputs("in")

        def conv_bn(name, inp, n_out, k, stride=1, act="relu"):
            g.add_layer(f"{name}_conv",
                        ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                         stride=(stride, stride),
                                         convolution_mode="same",
                                         activation="identity", has_bias=False), inp)
            # the activation rides the BN node so the fused BN+act kernels
            # can engage; `act=None` BNs (pre-residual-add) stay identity
            g.add_layer(f"{name}_bn",
                        BatchNormalization(activation=act or "identity"),
                        f"{name}_conv")
            return f"{name}_bn"

        def bottleneck(name, inp, f1, f2, f3, stride, project):
            x = conv_bn(f"{name}_a", inp, f1, 1, stride)
            x = conv_bn(f"{name}_b", x, f2, 3, 1)
            x = conv_bn(f"{name}_c", x, f3, 1, 1, act=None)
            if project:
                sc = conv_bn(f"{name}_sc", inp, f3, 1, stride, act=None)
            else:
                sc = inp
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
            g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
            return f"{name}_out"

        if self.stem_space_to_depth:
            g.add_layer("stem_s2d", SpaceToDepthLayer(block_size=2), "in")
            x = conv_bn("stem", "stem_s2d", 64, 4, 1)
        else:
            x = conv_bn("stem", "in", 64, 7, 2)
        g.add_layer("stem_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                                  convolution_mode="same"), x)
        x = "stem_pool"
        for si, (n_blocks, (f1, f2, f3)) in enumerate(self.STAGES):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = bottleneck(f"s{si}b{bi}", x, f1, f2, f3, stride, project=(bi == 0))
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("out", OutputLayer(n_in=self.STAGES[-1][1][2],
                                       n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        net = ComputationGraph(self.conf()).init(device=device)
        net.remat_segments = self.remat_segments
        if self.stem_space_to_depth:
            # keep the baseline stem's function family + init distribution:
            # draw a 7x7x3 kernel with the stem conv's own initializer and
            # fold it into the equivalent 4x4x12 layout
            w4 = net.params["stem_conv"]["W"]
            proto = ConvolutionLayer(n_out=w4.shape[-1], kernel_size=(7, 7))
            c_in = self.input_shape[-1]
            w7 = proto._make_weight(torch.Generator().manual_seed(self.seed),
                                    (7, 7, c_in, w4.shape[-1]))
            with torch.no_grad():
                w4.copy_(fold_stem_weights_s2d(w7).to(w4.dtype))
        return net


def fold_stem_weights_s2d(w7):
    """Fold a (7, 7, 3, F) stem kernel into the (4, 4, 12, F) kernel that
    computes the IDENTICAL conv(7x7, stride 2, SAME) on the
    space-to-depth(2) input.

    SAME 7x7/s2 on an even size pads (2, 3), so
    y[o] = sum_k x[2o + k - 2] W[k]. Writing k - 2 = 2*b + d with
    d in {0,1} gives block taps b in {-1..2} -> a 4-tap stride-1 conv in
    block space whose SAME padding for k=4 is exactly (1, 2). The s2d
    channel layout is (dh, dw, c) (SpaceToDepthLayer's order); the
    (b=2, d=1) position corresponds to k=7 and is zero."""
    kh, kw, c, f = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a (7, 7, C, F) kernel, got {tuple(w7.shape)}")
    w8 = torch.zeros((8, 8, c, f), dtype=w7.dtype, device=w7.device)
    w8[:7, :7] = w7
    # (8,8,c,f) -> (bh, dh, bw, dw, c, f) -> (bh, bw, dh, dw, c, f)
    w = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return w.reshape(4, 4, 4 * c, f)


# --------------------------------------------------------------------------
# Functional entry points over the same graph (bench / parallel use).
# --------------------------------------------------------------------------

def resnet50_init(key=None, num_classes=1000, dtype=torch.float32,
                  device=None):
    """The ResNet-50 graph initialized from seed 0 (``key`` and ``dtype``
    are unused, as in the reference)."""
    model = ResNet50(num_classes=num_classes, seed=0)
    return ComputationGraph(model.conf()).init(device=device)


def resnet50_apply(net, params, states, x, train=False, rng=None):
    acts, _, new_states = net._forward(params, states, {"in": x},
                                       train=train, rng=rng)
    return acts["out"], new_states
