"""Data containers, iterators, async prefetch and normalizers of the port."""

from .async_iter import AsyncDataSetIterator, maybe_wrap_async
from .dataset import DataSet, MultiDataSet
from .iterators import (ArrayDataSetIterator, BaseDatasetIterator,
                        Cifar10DataSetIterator, EmnistDataSetIterator,
                        IrisDataSetIterator, IteratorDataSetIterator,
                        KFoldIterator, ListDataSetIterator,
                        MnistDataSetIterator, MultipleEpochsIterator,
                        RandomDataSetIterator, make_synthetic_mnist)
from .normalizers import (CompositeDataSetPreProcessor,
                          ImagePreProcessingScaler,
                          MultiNormalizerMinMaxScaler,
                          MultiNormalizerStandardize, NormalizerMinMaxScaler,
                          NormalizerStandardize, VGG16ImagePreProcessor)

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "BaseDatasetIterator", "Cifar10DataSetIterator",
           "CompositeDataSetPreProcessor", "DataSet",
           "EmnistDataSetIterator", "ImagePreProcessingScaler",
           "IrisDataSetIterator", "IteratorDataSetIterator", "KFoldIterator",
           "ListDataSetIterator", "MnistDataSetIterator",
           "MultiDataSet", "MultiNormalizerMinMaxScaler",
           "MultiNormalizerStandardize", "MultipleEpochsIterator",
           "NormalizerMinMaxScaler", "NormalizerStandardize",
           "RandomDataSetIterator", "VGG16ImagePreProcessor",
           "make_synthetic_mnist", "maybe_wrap_async"]
