"""``mxnet_tpu_torch`` — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper, slice by slice.  Slice 1 is Llama generation serving: the model,
its flash-attention CUDA kernel, the paged KV cache, the
continuous-batching scheduler and the in-process model server.  Slice 2 is
the ResNet-50 v1 training step: the vision layers and model zoo, the fused
1x1-conv + BatchNorm-statistics CUDA kernel, the loss, SGD, bf16
conversion and ``CompiledTrainStep``.  Slice 3 is the imperative front end
(``Context``, the op registry, ``NDArray`` and ``mx.nd``, ``autograd``)
and runtime-compiled CUDA kernels (``rtc.CudaModule`` over NVRTC).
Slice 6 is the BERT-base pretraining step.  Slice 8 is the Gluon training
loop: ``gluon.Parameter``/``Block``/``Trainer`` with deferred init,
``mx.init``, ``mx.lr_scheduler``, ``mx.metric`` and ``mx.io.NDArrayIter``.

The package imports ``torch`` and numpy, never JAX and never ``mxnet_tpu``.
Entry points run on the card (``cuda``, ``mx.gpu(0)``) unless given the CPU
(``device="cpu"``, ``mx.cpu()``)."""
from . import (autograd, base, context, contrib, convert, error, executor,
               gluon, initializer, io, lr_scheduler, metric, name, ndarray,
               ops, optimizer, random, rtc, serving)
from .base import MXNetError, env
from .context import (Context, cpu, current_context, gpu, num_gpus,
                      resolve_device, set_default_context, tpu)
from .ndarray import NDArray, waitall

nd = ndarray
init = initializer

__all__ = ["autograd", "base", "context", "contrib", "convert", "error",
           "executor", "gluon", "init", "initializer", "io", "lr_scheduler",
           "metric", "name", "nd", "ndarray", "ops",
           "optimizer", "random", "rtc", "serving", "MXNetError", "env",
           "Context", "cpu", "gpu", "tpu", "current_context",
           "set_default_context", "num_gpus", "resolve_device", "NDArray",
           "waitall"]
