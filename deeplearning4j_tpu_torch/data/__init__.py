"""Data containers, iterators and normalizers of the port."""

from .dataset import DataSet, MultiDataSet
from .iterators import BaseDatasetIterator, ListDataSetIterator
from .normalizers import (CompositeDataSetPreProcessor,
                          ImagePreProcessingScaler,
                          MultiNormalizerMinMaxScaler,
                          MultiNormalizerStandardize, NormalizerMinMaxScaler,
                          NormalizerStandardize, VGG16ImagePreProcessor)

__all__ = ["BaseDatasetIterator", "CompositeDataSetPreProcessor", "DataSet",
           "ImagePreProcessingScaler", "ListDataSetIterator",
           "MultiDataSet", "MultiNormalizerMinMaxScaler",
           "MultiNormalizerStandardize", "NormalizerMinMaxScaler",
           "NormalizerStandardize", "VGG16ImagePreProcessor"]
