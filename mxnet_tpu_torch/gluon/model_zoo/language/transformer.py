"""Transformer encoder blocks in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/language/transformer.py``: the
same modules, parameter layout and order, and numerics.

- One packed QKV projection ``Dense(3·units)``, split into thirds.
- Attention is :func:`~mxnet_tpu_torch.ops.flash_attention`: the CUDA flash
  forward on the card with the blockwise backward, or the dense masked
  path when a ``valid_length`` is given.
- Dropout after the output projection and after the FFN only, never on
  the attention probabilities; post-LN residual wiring; gelu in the FFN.

Every ``Dropout`` of a block draws from the one ``torch.Generator`` the
block is given (``generator=``), or, without one, from the device's
``mx.random`` stream under the Gluon boundary; at rate 0 it is the
identity.

The blocks are Gluon ``HybridBlock``s built in the JAX package's name
scopes (``prefix=``), so ``collect_params()`` gives its names
(``bertmodel0_enc_layer0_attn_qkv_weight``) and ``save_parameters`` its
structural names (``encoder.layer0.attention.qkv.weight``).  Tensor and
NDArray calls take each block's ``forward``; a call with Symbols takes its
``hybrid_forward``, the JAX block's, in registry ops (``split`` into q, k
and v, then ``flash_attention``), so an encoder traces to the JAX
package's graph node for node.  At rate 0 a block's dropout adds no node,
as the JAX block then has none.  ``BERTModel`` stays without a symbolic
form: the JAX package cannot trace it.
"""
from __future__ import annotations

from ....context import resolve_device
from ....ops import F
from ...block import HybridBlock
from ...nn import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Self-attention over ``[B, S, units]`` with packed QKV; the heads
    stay packed ``[B, S, H·D]`` into the attention op."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, generator=None, device=None, **kwargs):
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        dev = resolve_device(device)
        super().__init__(device=dev, **kwargs)
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             in_units=units, prefix="qkv_", device=dev)
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              in_units=units, prefix="out_", device=dev)
            self.dropout = Dropout(dropout, generator=generator)

    def forward(self, x, valid_length=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.dropout(self.proj(F.flash_attention(
            q, k, v, valid_length, num_heads=self._num_heads,
            causal=self._causal)))

    def hybrid_forward(self, F, x, valid_length=None):
        q, k, v = F.split(self.qkv(x), num_outputs=3, axis=-1)
        if valid_length is not None:
            out = F.flash_attention(q, k, v, valid_length,
                                    num_heads=self._num_heads,
                                    causal=self._causal)
        else:
            out = F.flash_attention(q, k, v, num_heads=self._num_heads,
                                    causal=self._causal)
        out = self.proj(out)
        return self.dropout(out) if self.dropout._rate else out


class PositionwiseFFN(HybridBlock):
    """``Dense(hidden, activation)`` then ``Dense(units)``."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 generator=None, device=None, **kwargs):
        dev = resolve_device(device)
        super().__init__(device=dev, **kwargs)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False,
                              activation=activation, in_units=units,
                              prefix="ffn1_", device=dev)
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              prefix="ffn2_", device=dev)
            self.dropout = Dropout(dropout, generator=generator)

    def forward(self, x):
        return self.dropout(self.ffn2(self.ffn1(x)))

    def hybrid_forward(self, F, x):
        out = self.ffn2(self.ffn1(x))
        return self.dropout(out) if self.dropout._rate else out


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder cell: ``x = LN(x + MHA(x))``, ``x = LN(x + FFN(x))``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", causal=False, layer_norm_eps=1e-12,
                 generator=None, device=None, **kwargs):
        dev = resolve_device(device)
        super().__init__(device=dev, **kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(
                units, num_heads, dropout=dropout, causal=causal,
                generator=generator, device=dev, prefix="attn_")
            self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln1_", device=dev)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       activation=activation,
                                       generator=generator, device=dev,
                                       prefix="ffn_")
            self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln2_", device=dev)

    def forward(self, x, valid_length=None):
        x = self.ln1(x + self.attention(x, valid_length))
        return self.ln2(x + self.ffn(x))

    def hybrid_forward(self, F, x, valid_length=None):
        att = (self.attention(x) if valid_length is None
               else self.attention(x, valid_length))
        x = self.ln1(x + att)
        return self.ln2(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """A stack of ``num_layers`` encoder cells, registered as ``layer{i}``
    (``cells`` lists them)."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", causal=False, layer_norm_eps=1e-12,
                 generator=None, device=None, **kwargs):
        dev = resolve_device(device)
        super().__init__(device=dev, **kwargs)
        self.cells = []
        with self.name_scope():
            for i in range(num_layers):
                cell = TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    activation=activation, causal=causal,
                    layer_norm_eps=layer_norm_eps, generator=generator,
                    device=dev, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.cells.append(cell)

    def forward(self, x, valid_length=None):
        for cell in self.cells:
            x = cell(x, valid_length)
        return x

    def hybrid_forward(self, F, x, valid_length=None):
        for cell in self.cells:
            x = cell(x) if valid_length is None else cell(x, valid_length)
        return x
