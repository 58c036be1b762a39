"""Operators of the port: the registry with the elementwise, reduction,
shape, ordering, gather/scatter and product ops that ``mx.nd`` is
generated from; attention (with its CUDA kernel) and RoPE; the nn ops
with the fused RNN, the fused 1x1 conv + BN statistics (with its CUDA
kernel), the Embedding lookup (with its deterministic CUDA backward), the
deformable convolutions, every optimizer update, the samplers, the
reference's other op names (``parity``), linear algebra, the control-flow
ops, the image ops, the contrib index ops, the MoE FFN (``moe``) and,
registered from ``parallel.ring_attention``, the sequence-parallel
attention ops; ``kernels`` is the registry through which the ops with
hand-written kernels pick one.
``F`` is the namespace of op functions the Gluon layers call, which
autocasts their inputs under AMP (``registry.OpNamespace``)."""
from . import (attention, contrib_ops, control_flow, deformable, elemwise,
               embedding, fused_conv_bn, image, kernels, linalg, matrix, moe,
               nn, optimizer_ops, parity, random_ops, reduce, registry)
from .attention import attention_reference, flash_attention, rope
from ..parallel import ring_attention as _ring_attention  # noqa: F401

# the layers' functions that implement an op of another name
F = registry.OpNamespace(nn, attention, fused_conv_bn, names={
    "layer_norm": "LayerNorm", "instance_norm": "InstanceNorm",
    "group_norm": "GroupNorm", "sync_batch_norm": "_contrib_SyncBatchNorm",
    "rnn": "RNN", "leaky_relu": "LeakyReLU", "dropout": "Dropout",
    "embedding": "Embedding"})

__all__ = ["F", "attention_reference", "flash_attention", "rope", "attention",
           "contrib_ops", "control_flow", "deformable", "elemwise",
           "embedding", "fused_conv_bn", "image", "kernels", "linalg",
           "matrix", "moe", "nn", "optimizer_ops", "parity", "random_ops",
           "reduce", "registry"]
