"""Data iterators of the port (the part of ``mxnet_tpu/io`` that the Gluon
training loop uses)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
