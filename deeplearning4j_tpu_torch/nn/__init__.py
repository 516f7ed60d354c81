"""The DL4J layer API of the port (``deeplearning4j_tpu.nn`` analogue):
builders, the layers ResNet-50 needs, vertices and ComputationGraph."""

from . import activations, losses, weights
from .computation_graph import ComputationGraph, params_from_numpy
from .conf import NeuralNetConfiguration
from .graph import ComputationGraphConfiguration, GraphBuilder
from .layers.base import Ctx, InputType, Layer
from .layers.conv import (ConvolutionLayer, GlobalPoolingLayer, PoolingType,
                          SpaceToDepthLayer, SubsamplingLayer,
                          ZeroPaddingLayer)
from .layers.core import ActivationLayer, DenseLayer, LossLayer, OutputLayer
from .layers.norm import (BatchNormalization, LayerNormalization,
                          LocalResponseNormalization, RMSNorm)
from .vertices import (ElementWiseVertex, GraphVertex, L2NormalizeVertex,
                       L2Vertex, MergeVertex, PreprocessorVertex,
                       ReshapeVertex, ScaleVertex, ShiftVertex, StackVertex,
                       SubsetVertex, UnstackVertex)

__all__ = ["ActivationLayer", "BatchNormalization", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvolutionLayer", "Ctx",
           "DenseLayer", "ElementWiseVertex", "GlobalPoolingLayer",
           "GraphBuilder", "GraphVertex", "InputType", "L2NormalizeVertex",
           "L2Vertex", "Layer", "LayerNormalization",
           "LocalResponseNormalization", "LossLayer", "MergeVertex",
           "NeuralNetConfiguration", "OutputLayer", "PoolingType",
           "PreprocessorVertex", "RMSNorm", "ReshapeVertex", "ScaleVertex",
           "ShiftVertex", "SpaceToDepthLayer", "StackVertex",
           "SubsamplingLayer", "SubsetVertex", "UnstackVertex",
           "ZeroPaddingLayer", "activations", "losses", "params_from_numpy",
           "weights"]
