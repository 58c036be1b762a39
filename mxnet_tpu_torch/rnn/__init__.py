"""The symbolic RNN API of the port (counterpart of ``mxnet_tpu/rnn/``):
for now the data side that ``BucketingModule`` users feed from,
``encode_sentences`` and ``BucketSentenceIter``."""
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BucketSentenceIter", "encode_sentences"]
