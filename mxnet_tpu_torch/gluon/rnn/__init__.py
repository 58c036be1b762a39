"""Gluon recurrent layers (counterpart of ``mxnet_tpu/gluon/rnn/``): the
fused ``RNN``, ``LSTM`` and ``GRU`` layers.  The cells (``rnn_cell.py``)
are not ported yet."""
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU"]
