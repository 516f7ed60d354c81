"""The DL4J layer API of the port (``deeplearning4j_tpu.nn`` analogue):
builders, the layers ResNet-50, LeNet and the char-RNN need, vertices,
ComputationGraph and MultiLayerNetwork."""

from . import activations, losses, weights
from .computation_graph import ComputationGraph, params_from_numpy
from .conf import (ListBuilder, MultiLayerConfiguration,
                   NeuralNetConfiguration)
from .graph import ComputationGraphConfiguration, GraphBuilder
from .layers.base import Ctx, InputType, Layer
from .layers.conv import (ConvolutionLayer, GlobalPoolingLayer, PoolingType,
                          SpaceToDepthLayer, SubsamplingLayer,
                          ZeroPaddingLayer)
from .layers.core import (ActivationLayer, AlphaDropout, DenseLayer,
                          DropoutLayer, GaussianDropout, GaussianNoise,
                          LossLayer, OutputLayer, RnnOutputLayer,
                          SpatialDropout)
from .layers.norm import (BatchNormalization, LayerNormalization,
                          LocalResponseNormalization, RMSNorm)
from .layers.recurrent import (GRU, LSTM, Bidirectional, BidirectionalMode,
                               GravesBidirectionalLSTM, GravesLSTM,
                               LastTimeStep, SimpleRnn, TimeDistributed)
from .listeners import (CheckpointListener, CollectScoresListener,
                        EvaluativeListener, NanScoreWatchdog,
                        PerformanceListener, ScoreIterationListener,
                        TimeIterationListener, TrainingListener)
from .multi_layer_network import MultiLayerNetwork
from .weightnoise import (BernoulliDistribution, DropConnect,
                          NormalDistribution, UniformDistribution,
                          WeightNoise)
from .vertices import (ElementWiseVertex, GraphVertex, L2NormalizeVertex,
                       L2Vertex, MergeVertex, PreprocessorVertex,
                       ReshapeVertex, ScaleVertex, ShiftVertex, StackVertex,
                       SubsetVertex, UnstackVertex)

__all__ = ["ActivationLayer", "AlphaDropout", "BatchNormalization",
           "BernoulliDistribution", "Bidirectional", "BidirectionalMode",
           "CheckpointListener", "CollectScoresListener", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvolutionLayer", "Ctx",
           "DenseLayer", "DropConnect", "DropoutLayer", "ElementWiseVertex",
           "EvaluativeListener", "GRU", "GaussianDropout", "GaussianNoise",
           "GlobalPoolingLayer", "NanScoreWatchdog", "NormalDistribution",
           "PerformanceListener", "ScoreIterationListener",
           "SpatialDropout", "TimeIterationListener", "TrainingListener",
           "UniformDistribution", "WeightNoise",
           "GraphBuilder", "GraphVertex", "GravesBidirectionalLSTM",
           "GravesLSTM", "InputType", "L2NormalizeVertex", "L2Vertex",
           "LSTM", "LastTimeStep", "Layer", "LayerNormalization",
           "ListBuilder", "LocalResponseNormalization", "LossLayer",
           "MergeVertex", "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "OutputLayer", "PoolingType",
           "PreprocessorVertex", "RMSNorm", "ReshapeVertex",
           "RnnOutputLayer", "ScaleVertex", "ShiftVertex", "SimpleRnn",
           "SpaceToDepthLayer", "StackVertex", "SubsamplingLayer",
           "SubsetVertex", "TimeDistributed", "UnstackVertex",
           "ZeroPaddingLayer", "activations", "losses", "params_from_numpy",
           "weights"]
