"""``mxnet_tpu_torch`` — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper, slice by slice.  This slice is Llama generation serving: the model,
its flash-attention CUDA kernel, the paged KV cache, the continuous-batching
scheduler and the in-process model server.

The package imports ``torch`` and numpy, never JAX and never ``mxnet_tpu``.
Entry points run on ``cuda`` unless given ``device="cpu"``."""
from . import base, context, convert, gluon, initializer, ops, random, serving
from .base import MXNetError, env
from .context import resolve_device

__all__ = ["base", "context", "convert", "gluon", "initializer", "ops",
           "random", "serving", "MXNetError", "env", "resolve_device"]
