"""Operators of the port: the registry with the elementwise, reduction,
shape, ordering, gather/scatter and product ops that ``mx.nd`` is
generated from; attention (with its CUDA kernel) and RoPE; the nn ops
with the fused RNN, the fused 1x1 conv + BN statistics (with its CUDA
kernel), the Embedding lookup (with its deterministic CUDA backward), the
deformable convolutions, every optimizer update, the samplers and the
reference's other op names (``parity``)."""
from . import (deformable, elemwise, embedding, fused_conv_bn, matrix, nn,
               optimizer_ops, parity, random_ops, reduce, registry)
from .attention import attention_reference, flash_attention, rope

__all__ = ["attention_reference", "flash_attention", "rope", "deformable",
           "elemwise", "embedding", "fused_conv_bn", "matrix", "nn",
           "optimizer_ops", "parity", "random_ops", "reduce", "registry"]
