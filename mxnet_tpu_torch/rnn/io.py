"""Bucketing data iterator for language modelling (counterpart of
``mxnet_tpu/rnn/io.py``, reference ``python/mxnet/rnn/io.py``): sentences
are grouped into length buckets so that each batch is rectangular, and the
label at each position is the next token.  Each bucket length is one
signature of a ``BucketingModule`` (one executor, and on the card one set
of CUDA graphs), so few buckets keep the captures few.  Batches are CPU
NDArrays.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io import DataBatch, DataDesc, DataIter
from ..io.io import _host


def encode_sentences(sentences, vocab: Optional[Dict] = None,
                     invalid_label: int = -1, invalid_key: str = "\n",
                     start_label: int = 0, unknown_token: Optional[str] = None):
    """Token lists to id lists, building (or extending) a vocabulary
    (reference ``rnn/io.py`` ``encode_sentences``)."""
    new_vocab = vocab is None
    if new_vocab:
        vocab = {invalid_key: invalid_label}
        idx = start_label
    else:
        # number on past the existing ids: a new unknown_token must not
        # take an id already given
        used = [v for v in vocab.values() if v != invalid_label]
        idx = max(used, default=start_label - 1) + 1
        idx = max(idx, start_label)
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not (new_vocab or unknown_token):
                    raise ValueError(f"unknown token {word!r} with a fixed "
                                     "vocabulary and no unknown_token")
                if unknown_token and not new_vocab:
                    word_key = unknown_token
                else:
                    word_key = word
                if word_key not in vocab:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word_key] = idx
                    idx += 1
                word = word_key
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed (data, next-token label) batches for ``BucketingModule``
    (reference ``rnn/io.py:84``); the bucket order and each bucket's rows
    are shuffled at every reset from ``RandomState(seed)``."""

    def __init__(self, sentences: Sequence[Sequence[int]], batch_size: int,
                 buckets: Optional[List[int]] = None, invalid_label: int = -1,
                 data_name: str = "data", label_name: str = "softmax_label",
                 dtype: str = "float32", layout: str = "NT", seed: int = 0):
        super().__init__()
        lengths = [len(s) for s in sentences]
        if not buckets:
            counts = np.bincount(lengths)
            buckets = [i for i, c in enumerate(counts) if c >= batch_size]
            if not buckets:
                buckets = [max(lengths)]
        buckets = sorted(buckets)

        per_bucket: List[List[np.ndarray]] = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            b = bisect.bisect_left(buckets, len(sent))
            if b == len(buckets):
                ndiscard += 1
                continue
            row = np.full((buckets[b],), invalid_label, dtype)
            row[:len(sent)] = sent
            per_bucket[b].append(row)
        self.buckets = [blen for blen, rows in zip(buckets, per_bucket)
                        if rows]
        self.data = [np.asarray(rows, dtype) for rows in per_bucket if rows]
        if ndiscard:
            import logging
            logging.warning("BucketSentenceIter: discarded %d sentences "
                            "longer than the largest bucket", ndiscard)

        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError(f"layout must be NT or TN, got {layout}")
        self.default_bucket_key = max(self.buckets)
        shape = ((batch_size, self.default_bucket_key) if self.major_axis == 0
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape, np.dtype(dtype),
                                      layout)]
        self.provide_label = [DataDesc(label_name, shape, np.dtype(dtype),
                                       layout)]
        self._rng = np.random.RandomState(seed)
        self.idx: List = []
        for i, rows in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(rows) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        self._rng.shuffle(self.idx)
        for rows in self.data:
            self._rng.shuffle(rows)

    def next(self) -> DataBatch:
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        rows = self.data[i][j:j + self.batch_size]
        # next-token labels: shifted left, the tail invalid_label
        label = np.full_like(rows, self.invalid_label)
        label[:, :-1] = rows[:, 1:]
        if self.major_axis == 1:
            rows, label = rows.T, label.T
        blen = self.buckets[i]
        shape = ((self.batch_size, blen) if self.major_axis == 0
                 else (blen, self.batch_size))
        return DataBatch(
            [_host(rows)], [_host(label)], pad=0,
            bucket_key=blen,
            provide_data=[DataDesc(self.data_name, shape,
                                   np.dtype(self.dtype), self.layout)],
            provide_label=[DataDesc(self.label_name, shape,
                                    np.dtype(self.dtype), self.layout)])
