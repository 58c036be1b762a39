"""``mxnet_tpu_torch`` — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper, slice by slice.  Slice 1 is Llama generation serving: the model,
its flash-attention CUDA kernel, the paged KV cache, the
continuous-batching scheduler and the in-process model server.  Slice 2 is
the ResNet-50 v1 training step: the vision layers and model zoo, the fused
1x1-conv + BatchNorm-statistics CUDA kernel, the loss, SGD, bf16
conversion and ``CompiledTrainStep``.

The package imports ``torch`` and numpy, never JAX and never ``mxnet_tpu``.
Entry points run on ``cuda`` unless given ``device="cpu"``."""
from . import (base, context, contrib, convert, executor, gluon, initializer,
               ops, optimizer, random, serving)
from .base import MXNetError, env
from .context import resolve_device

__all__ = ["base", "context", "contrib", "convert", "executor", "gluon",
           "initializer", "ops", "optimizer", "random", "serving",
           "MXNetError", "env", "resolve_device"]
