"""Base utilities of the port: the framework error, the typed environment
flags, the dtype machinery with its 64-bit width policy, and the
shape-bucket helper.

Counterpart of ``mxnet_tpu/base.py``, reduced to what this package uses.
Every runtime flag is declared once in a typed registry and read live
through ``env.<NAME>``, with the same names and defaults as the JAX
package.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as _np
import torch

__all__ = ["MXNetError", "ServerClosedError", "RequestCancelledError",
           "EnvRegistry", "env", "row_bucket", "attr_truthy", "dtype_torch",
           "dtype_name", "numpy_dtype", "BFLOAT16", "narrow_source"]


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API parity with MXNet)."""


class ServerClosedError(MXNetError):
    """The serving frontend shut down while this request was still queued
    or running; the request did not finish."""


class RequestCancelledError(MXNetError):
    """The request was cancelled on purpose; its KV pages were freed
    immediately.  Not transient: retrying would be wrong."""


class EnvFlag:
    def __init__(self, name: str, default, typ: Callable, doc: str):
        self.name, self.default, self.typ, self.doc = name, default, typ, doc

    def read(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if self.typ is bool:
            return raw not in ("0", "false", "False", "")
        return self.typ(raw)


class EnvRegistry:
    """Declare-once runtime flags; ``env.MXNET_SERVING_KV_CACHE`` etc. read
    live from ``os.environ``."""

    def __init__(self):
        self._flags: Dict[str, EnvFlag] = {}

    def declare(self, name: str, default, typ=str, doc: str = "") -> None:
        self._flags[name] = EnvFlag(name, default, typ, doc)

    def __getattr__(self, name: str):
        flags = object.__getattribute__(self, "_flags")
        if name in flags:
            return flags[name].read()
        raise AttributeError(name)


env = EnvRegistry()
env.declare("MXNET_SERVING_KV_CACHE", True, bool,
            "Paged KV-cache decode for the GenerationScheduler when the "
            "model has cache_forward; 0 forces the dense no-cache engine.")
env.declare("MXNET_SERVING_PAGE_TOKENS", 16, int,
            "Tokens per KV-cache page.  Read at GenerationScheduler "
            "construction.")
env.declare("MXNET_SERVING_KV_PAGES", 0, int,
            "Physical pages in each model's KV page pool (page 0 is a "
            "reserved scratch page).  0 = auto-size: 1 + max_slots * "
            "ceil(max_length / page_tokens).")
env.declare("MXNET_SERVING_PREFIX_CACHE", True, bool,
            "Content-hash completed KV-cache pages so a later request with "
            "the same prompt prefix maps the same physical pages; 0 "
            "disables sharing.")
env.declare("MXNET_TPU_FAST_VARIANCE", 1, int,
            "Norm layers compute the variance one-pass as E[x^2]-E[x]^2, "
            "clamped at 0.  For activations with |mean| >> std the "
            "subtraction cancels; set 0 for the centred E[(x-mean)^2].")
env.declare("MXNET_TPU_FUSE_CONV_BN", 0, int,
            "1 = the model-zoo ResNet bottlenecks build their 1x1 conv+BN "
            "pairs as FusedConv1x1BN (the CUDA matmul with a BN-statistics "
            "epilogue, ops/fused_conv_bn.py) instead of Conv2D+BatchNorm.  "
            "Read when the block is constructed.")
env.declare("MXNET_TPU_RECOMPILE_WARN", 16, int,
            "CachedOp cache misses after which (misses > 2x hits) a "
            "recompile-storm warning fires once per op: the signature-churn "
            "failure mode where every request pays a capture.  0 disables "
            "(mxnet_tpu/base.py:480).")


# -- the kvstore (mxnet_tpu/base.py:184, :200, :336-365)
env.declare("MXNET_UPDATE_ON_KVSTORE", True, bool,
            "gluon.Trainer runs the optimizer inside the kvstore when one "
            "is engaged (the Trainer's update_on_kvstore=None).")
env.declare("MXNET_ASYNC_SYNC_INTERVAL", 16, int,
            "dist_async: pushes per key between cross-process averaging "
            "rounds of its stored value.")
env.declare("MXNET_KVSTORE_TIMEOUT", 0.0, float,
            "Seconds a dist kvstore collective may block: the process "
            "group's timeout (torch.distributed raises past it).  0 keeps "
            "torch's default.")
env.declare("MXNET_KVSTORE_BUCKET_KB", 4096, int,
            "Bucket capacity in KiB for a multi-key dense push: keys are "
            "concatenated into dtype-grouped flat buckets of at most this "
            "size and each bucket is reduced once (the results equal the "
            "per-key path bit for bit).  0 = one reduction per key.")
env.declare("MXNET_KVSTORE_SHARD", False, bool,
            "Optimizer-state sharding of the bucketed push (ZeRO, the JAX "
            "package's kvstore/sharded.py).  Not ported: a store asked "
            "for it raises at its push.")
env.declare("MXNET_KVSTORE_OVERLAP", True, bool,
            "Issue a bucket's all-reduce (async) the moment it fills, while "
            "later keys are still staged; off, every bucket waits for the "
            "end-of-push flush, which issues them in priority order.")


# -- the training step (mxnet_tpu/base.py:373)
env.declare("MXNET_TPU_STEPS_PER_CALL", 1, int,
            "K for MultiStepTrainStep: training steps one call takes from a "
            "super-batch with a leading K axis.  On the card they are K "
            "replays of the step's one CUDA graph, each with its own "
            "learning rate and step count; the results equal K single "
            "steps bit for bit.")


env.declare("MXNET_SERVING_MAX_QUEUE", 256, int,
            "Admission bound on a DynamicBatcher's queue (pending requests); "
            "submissions beyond it are shed with OverloadedError.")
env.declare("MXNET_SERVING_DEADLINE_MS", 0, int,
            "Default per-request serving deadline in milliseconds; a request "
            "still queued past it fails with DeadlineExceededError instead "
            "of occupying the batch.  0 = no default deadline.")


def attr_truthy(v) -> bool:
    """Truth of an op attribute that survives symbol-JSON round trips,
    where attrs can arrive as repr strings (``'False'``, ``'0'``): a plain
    ``bool()`` would read ``'False'`` as true."""
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1")
    return bool(v)


def row_bucket(n: int, minimum: int = 16) -> int:
    """Next power of two >= ``n``, floor ``minimum`` (the length ladder of
    the generation scheduler)."""
    return 1 << max((int(minimum) - 1).bit_length(), (int(n) - 1).bit_length())


env.declare("MXNET_SAFE_ACCUMULATION", True, bool,
            "Accumulate reductions in fp32.")
env.declare("MXNET_DEFAULT_DTYPE", "float32", str,
            "Default dtype for created arrays.")


# ---------------------------------------------------------------------------
# dtypes.  The JAX package names dtypes as numpy does and runs with JAX's
# x64 mode off, so a 64-bit request yields 32 bits there; the port keeps
# that width policy (``_NARROW``) so that both packages make the same
# arrays from the same source.
# ---------------------------------------------------------------------------
_DTYPE_ALIASES: Dict[Any, torch.dtype] = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    float: torch.float32, int: torch.int32, bool: torch.bool,
}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
_INT32 = (-(2 ** 31), 2 ** 31 - 1)


def _bfloat16_numpy():
    """numpy's bfloat16 when ``ml_dtypes`` is installed (the JAX package's
    bfloat16 is that dtype), else the name."""
    try:
        import ml_dtypes
    except ImportError:
        return "bfloat16"
    return _np.dtype(ml_dtypes.bfloat16)


BFLOAT16 = _bfloat16_numpy()


def dtype_torch(dtype, narrow: bool = True):
    """A user dtype spec (name, numpy dtype or type, Python type, torch
    dtype; ``None`` stays ``None``) as a torch dtype, with 64-bit types
    narrowed to 32 bits unless ``narrow`` is False."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        dt = dtype
    elif dtype in _DTYPE_ALIASES:
        dt = _DTYPE_ALIASES[dtype]
    else:
        name = str(dtype) if str(dtype) == "bfloat16" else _np.dtype(dtype).name
        try:
            dt = _DTYPE_ALIASES[name] if name in _DTYPE_ALIASES else getattr(
                torch, name)
        except AttributeError:
            raise TypeError(f"unsupported dtype {dtype!r}") from None
    return _NARROW.get(dt, dt) if narrow else dt


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype spec (``"bfloat16"`` included)."""
    return str(dtype_torch(dtype, narrow=False)).replace("torch.", "")


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (``BFLOAT16`` for bfloat16)."""
    if dtype == torch.bfloat16:
        return BFLOAT16
    return _np.dtype(dtype_name(dtype))


def narrow_source(a: _np.ndarray) -> _np.ndarray:
    """The 64-bit width policy of ``mxnet_tpu/ndarray/ndarray.py:618-649``
    on a numpy array: float64 becomes float32, and int64 becomes int32 when
    every value fits, else it raises (the JAX package, with x64 off, would
    otherwise truncate)."""
    if a.dtype == _np.int64:
        if a.size and (a.min() < _INT32[0] or a.max() > _INT32[1]):
            raise ValueError(
                f"int64 value out of int32 range (min {a.min()}, max "
                f"{a.max()}): arrays hold 32-bit integers, as the JAX "
                "package does with x64 disabled")
        return a.astype(_np.int32)
    if a.dtype == _np.float64:
        return a.astype(_np.float32)
    if a.dtype == _np.complex128:
        return a.astype(_np.complex64)
    return a
