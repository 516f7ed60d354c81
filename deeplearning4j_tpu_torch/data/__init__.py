"""Data containers of the port."""

from .dataset import DataSet, MultiDataSet

__all__ = ["DataSet", "MultiDataSet"]
