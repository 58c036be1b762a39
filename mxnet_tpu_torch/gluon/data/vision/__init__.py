"""Vision datasets and transforms of the port (counterpart of
``mxnet_tpu/gluon/data/vision/``)."""
from . import transforms
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset,
                       SyntheticImageDataset)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset",
           "SyntheticImageDataset", "transforms"]
