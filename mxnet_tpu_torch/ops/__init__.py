"""Operators of the port: attention (with its CUDA kernel) and RoPE."""
from .attention import attention_reference, flash_attention, rope

__all__ = ["attention_reference", "flash_attention", "rope"]
