"""Operators of the port: attention (with its CUDA kernel) and RoPE; the
training slice's nn ops, the fused 1x1 conv + BN statistics (with its CUDA
kernel) and the SGD updates."""
from . import fused_conv_bn, nn, optimizer_ops
from .attention import attention_reference, flash_attention, rope

__all__ = ["attention_reference", "flash_attention", "rope", "fused_conv_bn",
           "nn", "optimizer_ops"]
