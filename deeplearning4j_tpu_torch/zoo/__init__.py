"""Model zoo of the port: the Transformer-LM, ResNet-50, LeNet and the
char-RNN (TextGenerationLSTM)."""

from .cnn_simple import LeNet, TextGenerationLSTM
from .resnet import ResNet50

__all__ = ["LeNet", "ResNet50", "TextGenerationLSTM"]
