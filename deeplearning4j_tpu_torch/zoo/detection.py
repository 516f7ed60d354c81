"""Object-detection zoo models — port of
``deeplearning4j_tpu/zoo/detection.py`` (``org.deeplearning4j.zoo.model.
{TinyYOLO, YOLO2}``): Darknet backbones of conv-BN-leakyrelu blocks and a
``Yolo2OutputLayer``, NHWC. YOLO2's passthrough squeezes the 1/16 map to
64 channels with a 1×1 conv, SpaceToDepth's it to the head's grid and
merges it there (Darknet's yolov2.cfg). The leaky ReLU is a layer of its
own after each BN, as in the reference, so ``fused="auto"`` leaves the BNs
plain; with their ``fused=True`` each runs K3's ``bn_act`` at inference
on the card (8 a forward in TinyYOLO, 22 in YOLO2) and K3's training
kernels in ``fit``. ``compute_dtype`` runs the convs in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from ..nn.computation_graph import ComputationGraph
from ..nn.layers.base import InputType
from ..nn.layers.conv import (ConvolutionLayer, SpaceToDepthLayer,
                              SubsamplingLayer)
from ..nn.layers.core import ActivationLayer
from ..nn.layers.norm import BatchNormalization
from ..nn.layers.objdetect import Yolo2OutputLayer
from ..nn.multi_layer_network import MultiLayerNetwork
from ..nn.vertices import MergeVertex
from .base import ZooModel
from .cnn_simple import _builder

# reference anchor priors (grid units), TinyYOLO/YOLO2 defaults
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))
YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


@dataclass
class TinyYOLO(ZooModel):
    """TinyYOLO (YOLOv2-tiny on Darknet-tiny): 8 conv-BN-leaky blocks with
    maxpool downsampling + 1x1 detection conv + Yolo2OutputLayer."""

    num_classes: int = 20                  # VOC
    input_shape: Tuple = (416, 416, 3)
    anchors: Sequence[Tuple[float, float]] = TINY_YOLO_ANCHORS

    def conf(self):
        b = _builder(self.seed, self.updater, self.compute_dtype).list()

        def conv_bn(n):
            b.layer(ConvolutionLayer(n_out=n, kernel_size=(3, 3),
                                     convolution_mode="same",
                                     activation="identity", has_bias=False))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="leakyrelu"))

        for i, n in enumerate((16, 32, 64, 128, 256, 512)):
            conv_bn(n)
            stride = 1 if i == 5 else 2
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(stride, stride),
                                     convolution_mode="same"))
        conv_bn(1024)
        conv_bn(1024)
        n_a = len(self.anchors)
        b.layer(ConvolutionLayer(n_out=n_a * (5 + self.num_classes),
                                 kernel_size=(1, 1), convolution_mode="same",
                                 activation="identity"))
        b.layer(Yolo2OutputLayer(anchors=list(self.anchors)))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()

    def init(self, device=None):
        return MultiLayerNetwork(self.conf()).init(device=device)


@dataclass
class YOLO2(ZooModel):
    """YOLOv2 on Darknet-19 with the passthrough (reorg) connection: the
    1/16-resolution 512-channel map is squeezed to 64 channels by a 1x1
    conv, SpaceToDepth'd to 1/32 resolution x 256 channels, and merged with
    the 1024-channel head before detection. (This is the original Darknet
    yolov2.cfg passthrough; the reference's YOLO2 reorgs the 512-channel
    map directly without the 1x1 squeeze — same connectivity, wider merge.)"""

    num_classes: int = 80                  # COCO
    input_shape: Tuple = (608, 608, 3)
    anchors: Sequence[Tuple[float, float]] = YOLO2_ANCHORS

    def conf(self):
        g = (_builder(self.seed, self.updater, self.compute_dtype)
             .graph_builder().add_inputs("in"))
        idx = [0]

        def conv_bn(inp, n, k):
            name = f"c{idx[0]}"
            idx[0] += 1
            g.add_layer(f"{name}_conv",
                        ConvolutionLayer(n_out=n, kernel_size=(k, k),
                                         convolution_mode="same",
                                         activation="identity", has_bias=False), inp)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            g.add_layer(name, ActivationLayer(activation="leakyrelu"), f"{name}_bn")
            return name

        def pool(inp):
            name = f"p{idx[0]}"
            idx[0] += 1
            g.add_layer(name, SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), inp)
            return name

        # Darknet-19 feature extractor
        x = conv_bn("in", 32, 3)
        x = pool(x)
        x = conv_bn(x, 64, 3)
        x = pool(x)
        for trio in ((128, 64, 128), (256, 128, 256)):
            x = conv_bn(x, trio[0], 3)
            x = conv_bn(x, trio[1], 1)
            x = conv_bn(x, trio[2], 3)
            x = pool(x)
        x = conv_bn(x, 512, 3)
        x = conv_bn(x, 256, 1)
        x = conv_bn(x, 512, 3)
        x = conv_bn(x, 256, 1)
        passthrough = conv_bn(x, 512, 3)   # 1/16 res, 512ch
        x = pool(passthrough)
        x = conv_bn(x, 1024, 3)
        x = conv_bn(x, 512, 1)
        x = conv_bn(x, 1024, 3)
        x = conv_bn(x, 512, 1)
        x = conv_bn(x, 1024, 3)
        # detection head
        x = conv_bn(x, 1024, 3)
        x = conv_bn(x, 1024, 3)
        # passthrough: 1x1 squeeze + reorg to the head's resolution
        pt = conv_bn(passthrough, 64, 1)
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2), pt)
        g.add_vertex("merge", MergeVertex(), "reorg", x)
        x = conv_bn("merge", 1024, 3)
        n_a = len(self.anchors)
        g.add_layer("det_conv",
                    ConvolutionLayer(n_out=n_a * (5 + self.num_classes),
                                     kernel_size=(1, 1), convolution_mode="same",
                                     activation="identity"), x)
        g.add_layer("out", Yolo2OutputLayer(anchors=list(self.anchors)), "det_conv")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(*self.input_shape))
        return g.build()

    def init(self, device=None):
        return ComputationGraph(self.conf()).init(device=device)
