"""BERT in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/language/bert.py``.
:class:`BERTModel` is token, segment and position embeddings, a
:class:`~.transformer.TransformerEncoder` and a tanh pooler over token 0;
:class:`BERTForPretraining` adds the MLM head, whose decoder is tied to the
token embedding (the same ``nn.Parameter``, so the embedding's gradient is
the sum of the lookup's and the decoder's, as in the JAX package's
compiled step), and the NSP classifier.  Parameters register in the JAX
package's ``collect_params()`` order: a block's own tensors
(``mlm_bias``, ``position_weight``) before its children.

Both are Gluon ``HybridBlock``s with the JAX package's parameter names
(``bertmodel0_word_embed_weight``), so ``save_parameters`` files and
``collect_params()`` cross between the packages; calls with tensors stay
plain PyTorch.  They have no symbolic form, so ``export`` raises, as it
does in the JAX package (whose trace reads ``inputs.shape``, which a
Symbol does not have); BERT is served from its block.
"""
from __future__ import annotations

from ....base import MXNetError
from ....context import resolve_device
from ....ops import F
from ...block import HybridBlock
from ...nn import Dense, Dropout, Embedding, LayerNorm
from .transformer import TransformerEncoder

__all__ = ["BERTModel", "BERTForPretraining", "bert_12_768_12",
           "bert_24_1024_16", "get_bert"]


def _device(device, ctx):
    if device is None and ctx is not None:
        device = ctx.torch_device()
    return resolve_device(device)


class _NoSymbol:
    def _call_symbol(self, *args, **kwargs):
        raise MXNetError(f"{type(self).__name__} has no symbolic form: the "
                         "JAX package cannot trace BERT either (its trace "
                         "reads inputs.shape); serve the block itself")


class BERTModel(_NoSymbol, HybridBlock):
    """BERT backbone: ``forward(inputs [B, S] int, token_types [B, S]?,
    valid_length [B]?)`` -> ``(sequence [B, S, units], pooled [B, units])``.
    Positions come from a learned ``[max_length, units]`` table, zero at
    the start, sliced to S.  Every dropout draws from ``generator`` (or
    the device's ``mx.random`` stream).  Built on ``device`` (or ``ctx``;
    default ``cuda``, raising without CUDA)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, type_vocab=2,
                 dropout=0.1, layer_norm_eps=1e-12, generator=None,
                 device=None, ctx=None, **kwargs):
        dev = _device(device, ctx)
        super().__init__(device=dev, **kwargs)
        self._units = units
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_", device=dev)
            self.token_type_embed = Embedding(type_vocab, units,
                                              prefix="type_embed_",
                                              device=dev)
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init="zeros")
            self.embed_ln = LayerNorm(epsilon=layer_norm_eps,
                                      in_channels=units, prefix="embed_ln_",
                                      device=dev)
            self.embed_dropout = Dropout(dropout, generator=generator)
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, dropout=dropout,
                layer_norm_eps=layer_norm_eps, generator=generator,
                device=dev, prefix="enc_")
            self.pooler = Dense(units, flatten=False, activation="tanh",
                                in_units=units, prefix="pooler_", device=dev)

    def forward(self, inputs, token_types=None, valid_length=None):
        emb = self.word_embed(inputs)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = emb + self.position_weight[: inputs.shape[1]].unsqueeze(0)
        seq = self.encoder(self.embed_dropout(self.embed_ln(emb)),
                           valid_length)
        return seq, self.pooler(seq[:, 0])


class BERTForPretraining(_NoSymbol, HybridBlock):
    """MLM and NSP heads over the backbone: ``forward(inputs, token_types,
    valid_length?)`` -> ``(mlm_scores [B, S, vocab], nsp_scores [B, 2])``.
    ``mlm_ln`` keeps LayerNorm's default eps 1e-5; the backbone's use
    ``layer_norm_eps``."""

    def __init__(self, backbone=None, vocab_size=30522, generator=None,
                 device=None, ctx=None, prefix=None, params=None,
                 **bert_kwargs):
        dev = _device(device, ctx)
        super().__init__(device=dev, prefix=prefix, params=params)
        with self.name_scope():
            self.bert = backbone or BERTModel(vocab_size=vocab_size,
                                              generator=generator,
                                              device=dev, **bert_kwargs)
            units = self.bert._units
            self.mlm_transform = Dense(units, flatten=False,
                                       activation="gelu", in_units=units,
                                       prefix="mlm_trans_", device=dev)
            self.mlm_ln = LayerNorm(in_channels=units, prefix="mlm_ln_",
                                    device=dev)
            self.mlm_bias = self.params.get("mlm_bias", shape=(vocab_size,),
                                            init="zeros")
            self.nsp = Dense(2, flatten=False, in_units=units, prefix="nsp_",
                             device=dev)

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = self.mlm_ln(self.mlm_transform(seq))
        # the decoder reads the embedding table itself: [B, S, D] x [V, D]^T
        mlm = F.dot(h, self.bert.word_embed.weight,
                    transpose_b=True) + self.mlm_bias
        return mlm, self.nsp(pooled)


_SPECS = {
    # name: (num_layers, units, hidden, heads)
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
}


def get_bert(name, vocab_size=30522, max_length=512, dropout=0.1, **kwargs):
    """A :class:`BERTModel` of the named size (``bert_12_768_12``,
    ``bert_24_1024_16``)."""
    layers, units, hidden, heads = _SPECS[name]
    return BERTModel(vocab_size=vocab_size, units=units, hidden_size=hidden,
                     num_layers=layers, num_heads=heads,
                     max_length=max_length, dropout=dropout, **kwargs)


def bert_12_768_12(**kwargs):
    """BERT-base (L12 H768 A12)."""
    return get_bert("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large (L24 H1024 A16)."""
    return get_bert("bert_24_1024_16", **kwargs)
