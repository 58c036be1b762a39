"""Shape manipulation, slicing, joining, indexing, products and creation.

Counterpart of the part of ``mxnet_tpu/ops/matrix.py`` that ``NDArray``'s
methods and the imperative path reach (the reference's
``src/operator/tensor/matrix_op*.cc``, ``indexing_op.cc``, ``dot.cc`` and
``init_op.cc``), and of ``_slice_assign`` / ``_slice_assign_scalar`` from
``mxnet_tpu/ops/parity.py:164-172``.  A large product goes to
``torch.matmul``, as the JAX package leaves it to XLA.  Creation ops
(``nin=0``) take the target ``device`` from ``invoke``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import dtype_torch, numpy_dtype
from .registry import register


# ---------------------------------------------------------------------------
# reshape with the reference's special codes (matrix_op-inl.h
# InferReshapeShape): 0 = copy dim, -1 = infer, -2 = copy all remaining,
# -3 = merge two dims, -4 = split dim (followed by two sizes, one may be -1)
# ---------------------------------------------------------------------------
def _reshape_target(ishape: Tuple[int, ...], spec) -> Tuple[int, ...]:
    out = []
    i = 0
    spec = list(spec)
    j = 0
    while j < len(spec):
        d = spec[j]
        if d == 0:
            out.append(ishape[i]); i += 1
        elif d == -1:
            out.append(-1); i += 1
        elif d == -2:
            out.extend(ishape[i:]); i = len(ishape)
        elif d == -3:
            out.append(ishape[i] * ishape[i + 1]); i += 2
        elif d == -4:
            a, b = spec[j + 1], spec[j + 2]
            cur = ishape[i]
            if a == -1:
                a = cur // b
            if b == -1:
                b = cur // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(int(d)); i += 1
        j += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = int(np.prod(ishape)) // known
    return tuple(out)


@register("reshape", nin=1, aliases=["Reshape"])
def _reshape(data, shape=None, reverse=False):
    if reverse:
        tgt = tuple(reversed(_reshape_target(tuple(reversed(data.shape)),
                                             tuple(reversed(shape)))))
    else:
        tgt = _reshape_target(tuple(data.shape), shape)
    return torch.reshape(data, tgt)


@register("reshape_like", nin=2)
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None):
    """``lhs`` with its axes ``[lhs_begin, lhs_end)`` reshaped to ``rhs``'s
    axes ``[rhs_begin, rhs_end)`` (by default all of both)."""
    def norm(i, ndim, default):
        if i in (None, "None"):
            return default
        return int(i) + ndim if int(i) < 0 else int(i)
    lb, le = norm(lhs_begin, lhs.ndim, 0), norm(lhs_end, lhs.ndim, lhs.ndim)
    rb, re_ = norm(rhs_begin, rhs.ndim, 0), norm(rhs_end, rhs.ndim, rhs.ndim)
    return torch.reshape(lhs, tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                         + tuple(lhs.shape[le:]))


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source positions of an axis of ``n`` padded by ``lo``/``hi``:
    ``edge`` repeats the end elements, ``reflect`` mirrors about them
    (numpy's modes)."""
    idx = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return idx.clamp(0, n - 1)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


@register("pad", nin=1, aliases=["Pad"])
def _pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """Pad every axis by its ``(before, after)`` pair of ``pad_width`` (the
    reference's flat ``2·ndim`` tuple): ``constant`` with
    ``constant_value``, or ``edge`` / ``reflect`` as numpy's modes."""
    pw = [int(v) for v in pad_width]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        edges = tuple(e for lo, hi in reversed(pairs) for e in (lo, hi))
        return torch.nn.functional.pad(data, edges, value=float(
            constant_value))
    if mode not in ("edge", "reflect"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    out = data
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            out = torch.index_select(out, axis, _pad_index(
                out.shape[axis], lo, hi, mode, data.device))
    return out


@register("flatten", nin=1, aliases=["Flatten"])
def _flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose", nin=1)
def _transpose(data, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(*axes)


@register("swapaxes", nin=1, aliases=["SwapAxis"])
def _swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


@register("expand_dims", nin=1)
def _expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze", nin=1)
def _squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if any(data.shape[a] != 1 for a in axes):
        raise ValueError(f"cannot squeeze axes {axes} of shape "
                         f"{tuple(data.shape)}: their size is not 1")
    return torch.squeeze(data, axes)


@register("broadcast_to", nin=1)
def _broadcast_to(data, shape=None):
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like", nin=2)
def _broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(tgt))


# ---------------------------------------------------------------------------
# slicing
# ---------------------------------------------------------------------------
@register("slice", nin=1, aliases=["crop"])
def _slice(data, begin=None, end=None, step=None):
    from .elemwise import _getitem
    step = step or [None] * len(begin)
    return _getitem(data, tuple(slice(b, e, s)
                                for b, e, s in zip(begin, end, step)))


@register("slice_axis", nin=1)
def _slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("split", nin=1, nout=-1, aliases=["SliceChannel"])
def _split(data, num_outputs=1, axis=1, squeeze_axis=False):
    if data.shape[axis] % num_outputs:
        raise ValueError(f"axis {axis} of size {data.shape[axis]} does not "
                         f"split into {num_outputs} equal parts")
    parts = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("concat", nin=None, aliases=["Concat"])
def _concat(args, dim=1):
    return torch.cat(list(args), dim=dim)


@register("stack", nin=None)
def _stack(args, axis=0):
    return torch.stack(list(args), dim=axis)


# ---------------------------------------------------------------------------
# indexing (reference indexing_op.cc)
# ---------------------------------------------------------------------------
def _as_index(indices, size, mode):
    """Integer indices (float indices truncate, as the JAX package's int32
    cast does), clipped or wrapped into ``[0, size)``."""
    idx = indices.to(torch.int64)
    if mode == "wrap":
        return torch.remainder(idx, size)
    if mode == "clip":
        return torch.clamp(idx, 0, size - 1)
    return idx


@register("take", nin=2)
def _take(a, indices, axis=0, mode="clip"):
    axis = axis % a.ndim
    idx = _as_index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick", nin=2)
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    idx = _as_index(index, data.shape[axis], "clip" if mode == "clip"
                    else "wrap")
    picked = torch.gather(data, axis, torch.unsqueeze(idx, axis))
    return picked if keepdims else torch.squeeze(picked, axis)


@register("one_hot", nin=1)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    # an index outside [0, depth) gives a row of off_value, as jax.nn.one_hot
    hot = (indices.to(torch.int32).unsqueeze(-1) ==
           torch.arange(depth, device=indices.device)).to(dtype_torch(dtype))
    return hot * (on_value - off_value) + off_value


@register("where", nin=3)
def _where(condition, x, y):
    # a 1-D condition of length x.shape[0] selects whole rows (reference
    # control_flow_op.h WhereOpForward batch form); same-shape conditions
    # select elementwise
    cond = condition.to(torch.bool)
    if cond.ndim == 1 and x.ndim > 1 and cond.shape[0] == x.shape[0] \
            and cond.shape != x.shape:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond, x, y)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
def _reversed_axes(x):
    return x.permute(*reversed(range(x.ndim)))


@register("dot", nin=2)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = _reversed_axes(lhs) if transpose_a else lhs
    b = _reversed_axes(rhs) if transpose_b else rhs
    # reference dot: contract the last axis of a with the first axis of b
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", nin=2)
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("matmul", nin=2, aliases=["_npi_matmul"])
def _matmul(a, b):
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# creation ops (reference init_op.cc)
# ---------------------------------------------------------------------------
@register("_zeros", nin=0, differentiable=False)
def _zeros_op(shape=(), dtype="float32", device=None):
    return torch.zeros(shape, dtype=dtype_torch(dtype), device=device)


@register("_ones", nin=0, differentiable=False)
def _ones_op(shape=(), dtype="float32", device=None):
    return torch.ones(shape, dtype=dtype_torch(dtype), device=device)


@register("_full", nin=0, differentiable=False)
def _full_op(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(shape, value, dtype=dtype_torch(dtype), device=device)


def arange_values(start, stop, step, repeat, dtype) -> torch.Tensor:
    """``jnp.arange``'s values (numpy's, in the dtype when numpy has it),
    each repeated ``repeat`` times, on the CPU."""
    dt = dtype_torch(dtype)
    npdt = np.float32 if dt == torch.bfloat16 else numpy_dtype(dt)
    out = torch.from_numpy(np.arange(start, stop, step, dtype=npdt)).to(dt)
    return torch.repeat_interleave(out, repeat) if repeat > 1 else out


@register("_arange", nin=0, differentiable=False)
def _arange_op(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
               device=None):
    return arange_values(start, stop, step, repeat, dtype).to(device)


# ---------------------------------------------------------------------------
# slice assign (reference matrix_op.cc _slice_assign / _slice_assign_scalar)
# ---------------------------------------------------------------------------
def _build_slices(begin, end, step):
    step = tuple(step) if step else (None,) * len(begin)
    return tuple(slice(b, e, step[i] if i < len(step)
                       and step[i] not in (None, 0) else 1)
                 for i, (b, e) in enumerate(zip(begin, end)))


@register("_slice_assign", nin=2, aliases=["_crop_assign"])
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    out = lhs.clone()
    out[_build_slices(begin, end, step)] = rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar", nin=1, aliases=["_crop_assign_scalar"])
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_build_slices(begin, end, step)] = scalar
    return out
