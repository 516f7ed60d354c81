"""Data containers and iterators of the port."""

from .dataset import DataSet, MultiDataSet
from .iterators import BaseDatasetIterator, ListDataSetIterator

__all__ = ["BaseDatasetIterator", "DataSet", "ListDataSetIterator",
           "MultiDataSet"]
