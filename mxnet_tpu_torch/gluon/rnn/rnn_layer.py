"""Fused RNN layers over the ``RNN`` op (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``, reference
``python/mxnet/gluon/rnn/rnn_layer.py:34``).

The parameters keep the reference's names (``l0_i2h_weight``,
``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``, ``r0_...`` for the
reverse direction of a bidirectional layer) and its deferred input size
(``input_size=0`` takes the width of the first input).  As in the JAX
package, each forward packs them into the op's flat vector (per layer,
per direction: ``wx, wh, bx, bh``), one concatenation of the weights,
which autograd takes apart again in the backward; the op then feeds each
layer's slice of that vector to cuDNN as it is
(:func:`~mxnet_tpu_torch.ops.nn.rnn`).  In training the dropout between
layers draws from the device's ``mx.random`` stream.
"""
from __future__ import annotations

import torch

from ... import random as _random
from ...ndarray import ndarray as _nd
from ...ops import F
from ...ops.nn import _RNN_GATES
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"invalid layout {layout}; TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng, nh = _RNN_GATES[mode], hidden_size
        self._names = []
        with self.name_scope():
            for i in range(num_layers):
                ni = input_size if i == 0 else nh * self._dir
                for j in ["l", "r"][:self._dir]:
                    for part, shape, init in (
                            ("i2h_weight", (ng * nh, ni),
                             i2h_weight_initializer),
                            ("h2h_weight", (ng * nh, nh),
                             h2h_weight_initializer),
                            ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                            ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                        name = f"{j}{i}_{part}"
                        setattr(self, name, self.params.get(
                            name, shape=shape, init=init,
                            allow_deferred_init=True))
                        self._names.append(name)

    def _shape_hint(self, inputs, *args):
        ng, nh = _RNN_GATES[self._mode], self._hidden_size
        for j in ["l", "r"][:self._dir]:
            self._reg_params[f"{j}0_i2h_weight"].shape = (
                ng * nh, inputs.shape[-1])

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states as NDArrays, zeros unless ``func`` (an
        ``mx.nd`` creator) is given."""
        f = func or _nd.zeros
        return [f(info["shape"], ctx=ctx) if ctx is not None
                else f(info["shape"]) for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        """``inputs`` [T, N, C] (``TNC``) or [N, T, C] (``NTC``); returns
        the output, and the final states when ``states`` were given."""
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        skip_states = states is None
        if skip_states:
            shape = (self._num_layers * self._dir, x.shape[1],
                     self._hidden_size)
            states = [x.new_zeros(shape)] * (2 if self._mode == "lstm"
                                             else 1)
        elif isinstance(states, torch.Tensor):
            states = [states]
        flat = torch.cat([getattr(self, n).reshape(-1) for n in self._names])
        drop = self.training and self._dropout > 0
        outs = F.rnn(x, flat, states[0], states[1] if self._mode == "lstm"
                     else None, self._hidden_size, self._num_layers,
                     self._mode, self._dir == 2, self._dropout, drop,
                     _random.device_generator(x.device) if drop else None)
        out = outs[0].transpose(0, 1) if self._layout == "NTC" else outs[0]
        return out if skip_states else (out, list(outs[1:]))

    def extra_repr(self):
        return (f"{self._hidden_size}, {self._layout}, "
                f"layers={self._num_layers}, "
                f"bidirectional={self._dir == 2}")


class RNN(_RNNLayer):
    """Elman RNN, ``activation`` ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Long short-term memory (gates i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Gated recurrent unit (gates r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
