"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``, reference
``python/mxnet/gluon/data/vision/datasets.py``).

Each dataset parses files already on disk (MNIST idx, CIFAR binary,
RecordIO, image folders); nothing is downloaded.  Images are CPU uint8
NDArrays, HWC.  ``SyntheticImageDataset`` makes seeded images for
benchmarks and tests.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import List

import numpy as _np

from ....context import cpu
from ....ndarray import ndarray as _nd
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset",
           "ImageFolderDataset", "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from the idx files under ``root``
    (``train-images-idx3-ubyte[.gz]`` and the rest)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_path = self._find(files[0])
        lbl_path = self._find(files[1])
        with self._open(lbl_path) as f:
            magic, num = struct.unpack(">II", f.read(8))
            label = _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)
        with self._open(img_path) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            data = _np.frombuffer(f.read(), dtype=_np.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._data = _nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = label

    def _find(self, base):
        for cand in (os.path.join(self._root, base),
                     os.path.join(self._root, base + ".gz"), base,
                     base + ".gz"):
            if os.path.exists(cand):
                return cand
        raise IOError(f"MNIST file {base} not found under {self._root}: "
                      "place the idx files there (nothing is downloaded)")

    @staticmethod
    def _open(path):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        return open(path, "rb")


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the binary batches under `root`."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._file_hashes = None
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = _np.frombuffer(f.read(), dtype=_np.uint8)
        rec = raw.reshape(-1, 3072 + self._label_bytes())
        label = rec[:, self._label_bytes() - 1].astype(_np.int32)
        data = rec[:, self._label_bytes():].reshape(-1, 3, 32, 32)
        data = data.transpose(0, 2, 3, 1)
        return data, label

    def _label_bytes(self):
        return 1

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}.bin" for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        data, label = [], []
        for base in self._file_list():
            path = os.path.join(self._root, base)
            if not os.path.exists(path):
                sub = os.path.join(self._root, "cifar-10-batches-bin", base)
                if os.path.exists(sub):
                    path = sub
                else:
                    raise IOError(f"CIFAR file {base} not found under "
                                  f"{self._root}: place the binary batches "
                                  "there (nothing is downloaded)")
            d, l = self._read_batch(path)
            data.append(d)
            label.append(l)
        self._data = _nd.array(_np.concatenate(data), ctx=cpu(),
                               dtype="uint8")
        self._label = _np.concatenate(label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _label_bytes(self):
        return 2

    def _file_list(self):
        return ["train.bin"] if self._train else ["test.bin"]


class ImageRecordDataset(Dataset):
    """Images and labels from a RecordIO file of image records (reference
    vision ``ImageRecordDataset``)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = self._record[idx]
        header, img = unpack_img(record, iscolor=self._flag)
        label = header.label
        img = _nd.array(img, ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """One class per subfolder of ``root``; ``.npy`` files load with numpy,
    other images decode with ``mx.image.imread``."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets: List[str] = []
        self.items: List = []
        self._list_images(self._root)

    def _list_images(self, root):
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                self.items.append((os.path.join(path, filename), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
        else:
            from ....image import imread
            with cpu():
                img = imread(path, self._flag)
        img = _nd.array(img, ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class SyntheticImageDataset(Dataset):
    """Seeded uint8 images and labels (item i from ``RandomState(seed +
    i)``), an ImageNet-shaped pipeline without files (no reference
    counterpart)."""

    def __init__(self, num_samples=1024, shape=(224, 224, 3), num_classes=1000,
                 seed=0, transform=None):
        self._n = num_samples
        self._shape = shape
        self._classes = num_classes
        self._seed = seed
        self._transform = transform

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        rng = _np.random.RandomState(self._seed + idx)
        img = rng.randint(0, 256, size=self._shape, dtype=_np.uint8)
        label = int(rng.randint(0, self._classes))
        data = _nd.array(img, ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(data, label)
        return data, label
