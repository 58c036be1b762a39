"""Base utilities of the port: the framework error, the typed environment
flags the serving and training slices read, and the shape-bucket helper.

Counterpart of ``mxnet_tpu/base.py``, reduced to what this package uses.
Every runtime flag is declared once in a typed registry and read live
through ``env.<NAME>``, with the same names and defaults as the JAX
package.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

__all__ = ["MXNetError", "ServerClosedError", "RequestCancelledError",
           "EnvRegistry", "env", "row_bucket"]


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


def row_bucket(n: int, minimum: int = 16) -> int:
    """Next power of two >= ``n``, floor ``minimum`` (the length ladder of
    the generation scheduler)."""
    return 1 << max((int(minimum) - 1).bit_length(), (int(n) - 1).bit_length())
