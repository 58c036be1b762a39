"""Contrib ops of ``mx.nd.contrib`` (counterpart of part of
``mxnet_tpu/ops/contrib_ops.py``): the tutorial ``quadratic`` and the
index ops of ``contrib/index_array.cc`` and ``contrib/index_copy.cc``.
The rest of the JAX package's contrib ops (detection, quantization, FFT,
the interleaved attention products) are not ported yet."""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


@register("_contrib_quadratic", nin=1, aliases=["quadratic"])
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """a·x² + b·x + c (``contrib/quadratic_op-inl.h``)."""
    return float(a) * data * data + float(b) * data + float(c)


@register("_contrib_index_array", nin=1, differentiable=False,
          aliases=["index_array"])
def _index_array(data, axes=None):
    """The coordinates of every element: ``out[i0..ik, j] = i_{axes[j]}``,
    int32 (the JAX package's index width; the reference's is int64)."""
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int32,
                                          device=data.device)
                             for s in data.shape], indexing="ij")
    sel = range(data.dim()) if axes is None else [int(a) for a in axes]
    return torch.stack([grids[a] for a in sel], dim=-1)


@register("_contrib_index_copy", nin=3, aliases=["index_copy"])
def _index_copy(old, index, new):
    """``old`` with the rows ``index`` (along axis 0) replaced by ``new``'s
    rows; the gradient is the output's with those rows zeroed for
    ``old`` and those rows for ``new``."""
    return old.index_copy(0, index.reshape(-1).long(), new.to(old.dtype))
