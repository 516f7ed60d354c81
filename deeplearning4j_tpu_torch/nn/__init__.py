"""The DL4J layer API of the port (``deeplearning4j_tpu.nn`` analogue):
builders, the layers, vertices, ComputationGraph and MultiLayerNetwork,
transfer learning."""

from . import activations, losses, weights
from .computation_graph import ComputationGraph, params_from_numpy
from .conf import (ListBuilder, MultiLayerConfiguration,
                   NeuralNetConfiguration)
from .graph import ComputationGraphConfiguration, GraphBuilder
from .layers.attention import (AttentionVertex, LearnedSelfAttentionLayer,
                               RecurrentAttentionLayer, SelfAttentionLayer)
from .layers.base import Ctx, InputType, Layer
from .layers.capsule import (CapsuleLayer, CapsuleStrengthLayer,
                             PrimaryCapsules)
from .layers.conv import (ConvolutionLayer, Convolution1DLayer,
                          Convolution3DLayer, Cropping1D, Cropping2D,
                          Cropping3D, Deconvolution2D, Deconvolution3D,
                          DepthToSpaceLayer, DepthwiseConvolution2D,
                          GlobalPoolingLayer, LocallyConnected1D,
                          LocallyConnected2D, PoolingType,
                          SeparableConvolution2D, SpaceToDepthLayer,
                          Subsampling1DLayer, Subsampling3DLayer,
                          SubsamplingLayer, Upsampling1D, Upsampling2D,
                          Upsampling3D, ZeroPadding1DLayer,
                          ZeroPadding3DLayer, ZeroPaddingLayer)
from .layers.core import (ActivationLayer, AlphaDropout,
                          CenterLossOutputLayer, CnnLossLayer, DenseLayer,
                          DropoutLayer, ElementWiseMultiplicationLayer,
                          EmbeddingLayer, EmbeddingSequenceLayer,
                          GaussianDropout, GaussianNoise, LossLayer,
                          MaskLayer, OCNNOutputLayer, OutputLayer,
                          PermuteLayer, PReLULayer, ReshapeLayer,
                          RnnOutputLayer, SpatialDropout)
from .layers.norm import (BatchNormalization, LayerNormalization,
                          LocalResponseNormalization, RMSNorm)
from .layers.objdetect import (DetectedObject, Yolo2OutputLayer,
                               get_predicted_objects, nms)
from .layers.recurrent import (GRU, LSTM, Bidirectional, BidirectionalMode,
                               ConvLSTM2D, GravesBidirectionalLSTM,
                               GravesLSTM, LastTimeStep, SimpleRnn,
                               TimeDistributed)
from .layers.samediff_layer import (SameDiffLambdaLayer,
                                    SameDiffLambdaVertex, SameDiffLayer,
                                    SameDiffOutputLayer, SameDiffVertex,
                                    SDLayerParams)
from .layers.variational import VariationalAutoencoder
from .layers.wrappers import (FrozenLayer, FrozenLayerWithBackprop,
                              MaskZeroLayer, RepeatVector,
                              TimeDistributedLayer)
from .listeners import (CheckpointListener, CollectScoresListener,
                        EvaluativeListener, NanScoreWatchdog,
                        PerformanceListener, ScoreIterationListener,
                        TimeIterationListener, TrainingListener)
from .multi_layer_network import MultiLayerNetwork
from .transfer import (FineTuneConfiguration, TransferLearning,
                       TransferLearningHelper)
from .weightnoise import (BernoulliDistribution, DropConnect,
                          NormalDistribution, UniformDistribution,
                          WeightNoise)
from .vertices import (ElementWiseVertex, GraphVertex, L2NormalizeVertex,
                       L2Vertex, MergeVertex, PreprocessorVertex,
                       ReshapeVertex, ScaleVertex, ShiftVertex, StackVertex,
                       SubsetVertex, UnstackVertex)

__all__ = sorted(n for n in dir() if not n.startswith("_")
                 and n not in ("annotations",))
