"""Data IO of the port (counterpart of ``mxnet_tpu/io/``): the
iterators, the prefetchers and the native recordio reader."""
from .io import (CSRBatch, CSVIter, DataBatch, DataDesc, DataIter,
                 ImageDetRecordIter, ImageRecordInt8Iter, ImageRecordIter,
                 ImageRecordUInt8Iter, LibSVMIter, MNISTIter, MXDataIter,
                 NDArrayIter, PrefetchingIter, ResizeIter)
from .device_prefetch import DevicePrefetchIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter",
           "ImageRecordUInt8Iter", "ImageRecordInt8Iter",
           "MNISTIter", "LibSVMIter", "MXDataIter", "CSRBatch"]
