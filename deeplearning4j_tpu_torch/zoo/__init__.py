"""Model zoo of the port: the Transformer-LM and BERT, ResNet-50, the
sequential CNNs (LeNet, SimpleCNN, AlexNet, VGG16/19, Darknet19) and
SqueezeNet, the char-RNN (TextGenerationLSTM), TinyYOLO and YOLO2, the
Inception family (Xception, InceptionResNetV1, FaceNetNN4Small2), NASNet
and UNet."""

from .base import ZooModel
from .cnn_simple import (AlexNet, Darknet19, LeNet, SimpleCNN, SqueezeNet,
                         TextGenerationLSTM, VGG16, VGG19)
from .detection import TINY_YOLO_ANCHORS, YOLO2, YOLO2_ANCHORS, TinyYOLO
from .inception import FaceNetNN4Small2, InceptionResNetV1, Xception
from .nasnet import NASNet
from .resnet import ResNet50
from .unet import UNet

__all__ = ["AlexNet", "Darknet19", "FaceNetNN4Small2", "InceptionResNetV1",
           "LeNet", "NASNet", "ResNet50", "SimpleCNN", "SqueezeNet",
           "TINY_YOLO_ANCHORS", "TextGenerationLSTM", "TinyYOLO", "UNet",
           "VGG16", "VGG19", "Xception", "YOLO2", "YOLO2_ANCHORS",
           "ZooModel"]
