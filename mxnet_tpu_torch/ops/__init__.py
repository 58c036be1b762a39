"""Operators of the port: the registry with the elementwise, reduction and
shape/product ops that ``mx.nd`` is generated from; attention (with its
CUDA kernel) and RoPE; the training slice's nn ops, the fused 1x1 conv + BN
statistics (with its CUDA kernel), the Embedding lookup (with its
deterministic CUDA backward) and the SGD updates."""
from . import (elemwise, embedding, fused_conv_bn, matrix, nn, optimizer_ops,
               reduce, registry)
from .attention import attention_reference, flash_attention, rope

__all__ = ["attention_reference", "flash_attention", "rope", "elemwise",
           "embedding", "fused_conv_bn", "matrix", "nn", "optimizer_ops",
           "reduce", "registry"]
