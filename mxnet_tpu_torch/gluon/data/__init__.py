"""Gluon's data API of the port (counterpart of ``mxnet_tpu/gluon/data/``,
reference ``python/mxnet/gluon/data/``): datasets, samplers, the
``DataLoader`` and the vision datasets and transforms.  All of it is host
code: batches leave as CPU NDArrays, and ``io.DevicePrefetchIter`` stages
them onto the card."""
from . import vision
from .dataloader import DataLoader
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, FilterSampler, RandomSampler, Sampler,
                      SequentialSampler)

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "DataLoader", "vision"]
