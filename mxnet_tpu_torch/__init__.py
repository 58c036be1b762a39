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
Slice 9 is export, import and serving: ``mx.sym`` with its ``Executor``,
``HybridBlock.export``/``SymbolBlock``, ``CachedOp`` and the
non-generative ``ModelServer.register`` path (engine, batcher, client).
Slice 10 is the symbolic training loop: ``mx.module`` (``Module``,
``BucketingModule``), ``mx.model`` checkpoints, ``mx.callback`` and the
one-process ``mx.kvstore`` (``'local'``, ``'device'``).  Slice 11 is the
distributed kvstore: ``mx.distributed`` over ``torch.distributed``, the
``dist_*`` stores, bucketed pushes and 2-bit compression.

The package imports ``torch`` and numpy, never JAX and never ``mxnet_tpu``.
Entry points run on the card (``cuda``, ``mx.gpu(0)``) unless given the CPU
(``device="cpu"``, ``mx.cpu()``)."""
from . import (autograd, base, callback, context, contrib, convert,
               distributed, error, executor, gluon, initializer, io, kvstore,
               lr_scheduler, metric, model, module, name, ndarray, ops,
               optimizer, parallel, random, rtc, serving, symbol)
from .base import MXNetError, env
from .context import (Context, cpu, current_context, gpu, num_gpus,
                      resolve_device, set_default_context, tpu)
from .model import load_checkpoint, save_checkpoint
from .ndarray import NDArray, waitall

nd = ndarray
init = initializer
sym = symbol
kv = kvstore

__all__ = ["autograd", "base", "callback", "context", "contrib", "convert",
           "distributed", "error", "executor", "gluon", "init", "initializer",
           "io", "kv", "kvstore", "lr_scheduler", "metric", "model", "module",
           "name", "nd", "ndarray", "ops", "optimizer", "parallel", "random",
           "rtc", "serving",
           "sym", "symbol", "save_checkpoint", "load_checkpoint",
           "MXNetError", "env",
           "Context", "cpu", "gpu", "tpu", "current_context",
           "set_default_context", "num_gpus", "resolve_device", "NDArray",
           "waitall"]
