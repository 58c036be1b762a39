"""Reduction ops (reference ``src/operator/tensor/broadcast_reduce_op_value.cc``).

Counterpart of ``mxnet_tpu/ops/reduce.py``: the reference's
``axis``/``keepdims``/``exclude`` semantics; float16/bfloat16 inputs
accumulate in fp32 under ``MXNET_SAFE_ACCUMULATION``.  Integer sums and
products keep the input's dtype, as they do in the JAX package (torch
would widen them to int64).
"""
from __future__ import annotations

import torch

from ..base import dtype_torch, env
from .registry import register


def _axes(data, axis, exclude):
    if axis is None:
        ax = tuple(range(data.ndim))
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    if exclude:
        ax = tuple(i for i in range(data.ndim)
                   if i not in ax and i - data.ndim not in ax)
    return ax if ax else None


def _acc(data):
    if env.MXNET_SAFE_ACCUMULATION and data.dtype in (torch.float16,
                                                      torch.bfloat16):
        return data.float(), data.dtype
    return data, None


def _prod(x, dim, keepdim):
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, d, keepdim=True)
    return x if keepdim else x.squeeze(dim)


def _mean(x, dim, keepdim):
    return torch.mean(x if x.is_floating_point() else x.float(), dim,
                      keepdim=keepdim)


_TORCH_REDUCE = {
    "sum": lambda x, d, k: torch.sum(x, d, keepdim=k),
    "mean": _mean,
    "prod": _prod,
    "nansum": lambda x, d, k: torch.nansum(x, d, keepdim=k),
    "nanprod": lambda x, d, k: _prod(torch.where(torch.isnan(x), 1, x), d, k),
    "max": lambda x, d, k: torch.amax(x, d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, d, keepdim=k),
}


def _reduce(fn):
    def impl(data, axis=None, keepdims=False, exclude=False):
        x, restore = _acc(data)
        ax = _axes(data, axis, exclude)
        out = fn(x, tuple(range(data.ndim)) if ax is None else ax, keepdims)
        if restore is not None:
            return out.to(restore)
        return out if out.is_floating_point() else out.to(data.dtype)
    return impl


for _name, _aliases in (("sum", ["sum_axis"]), ("mean", []), ("prod", []),
                        ("nansum", []), ("nanprod", []),
                        ("max", ["max_axis"]), ("min", ["min_axis"])):
    register(_name, nin=1, aliases=_aliases)(_reduce(_TORCH_REDUCE[_name]))


@register("norm", nin=1)
def _norm(data, ord=2, axis=None, keepdims=False, out_dtype=None):
    x, restore = _acc(data)
    ax = (tuple(range(data.ndim)) if axis is None else
          tuple(axis) if isinstance(axis, (tuple, list)) else (axis,))
    if ord == 1:
        out = torch.sum(torch.abs(x), ax, keepdim=keepdims)
    else:
        out = torch.sqrt(torch.sum(torch.square(x), ax, keepdim=keepdims))
    if out_dtype is not None:
        return out.to(dtype_torch(out_dtype))
    return out.to(restore) if restore is not None else out


@register("L2Normalization", nin=1)
def _l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, data.ndim))
    elif mode == "channel":
        ax = (1,)
    else:  # spatial
        ax = tuple(range(2, data.ndim))
    nrm = torch.sqrt(torch.sum(torch.square(data), ax, keepdim=True) + eps)
    return data / nrm


@register("moments", nin=1, nout=2)
def _moments(data, axes=None, keepdims=False):
    ax = (tuple(range(data.ndim)) if axes is None else
          (axes,) if isinstance(axes, int) else tuple(axes))
    # centred two-pass form, as the JAX package (E[x^2]-E[x]^2 cancels)
    mean = torch.mean(data, ax, keepdim=True)
    var = torch.mean(torch.square(data - mean), ax, keepdim=keepdims)
    return (mean if keepdims else mean.squeeze(ax)), var


@register("logsumexp", nin=1)
def _logsumexp(data, axis=None, keepdims=False):
    ax = tuple(range(data.ndim)) if axis is None else axis
    return torch.logsumexp(data, ax, keepdim=keepdims)


@register("cumsum", nin=1, aliases=["_np_cumsum"])
def _cumsum(data, axis=None, dtype=None):
    x = data if dtype is None else data.to(dtype_torch(dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, axis, dtype=x.dtype)
