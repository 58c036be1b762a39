"""Shape manipulation, slicing, joining, indexing, ordering, sequences,
products and creation.

Counterpart of ``mxnet_tpu/ops/matrix.py`` (the reference's
``src/operator/tensor/matrix_op*.cc``, ``indexing_op.cc``,
``ordering_op.cc``, ``dot.cc``, ``init_op.cc`` and the sequence ops), and
of ``_slice_assign`` / ``_slice_assign_scalar`` from
``mxnet_tpu/ops/parity.py:164-172``.  The ordering ops sort stably, so
ties come out as ``lax.top_k`` and jnp's sort give them on every device;
the scatters that add or overwrite duplicates do so in a fixed order.  A
large product goes to ``torch.matmul``, as the JAX package leaves it to
XLA.  Creation ops (``nin=0``) take the target ``device`` from
``invoke``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import MXNetError, attr_truthy, dtype_torch, numpy_dtype
from .registry import alias, register


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
    # mixed operands meet in their common dtype, as jnp.dot promotes them
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
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


# ---------------------------------------------------------------------------
# layout (reference matrix_op.cc: flip, tile, repeat, broadcast_axis,
# slice_like, split_v2, depth_to_space, space_to_depth)
# ---------------------------------------------------------------------------
def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)


@register("flip", nin=1, aliases=["reverse"])
def _flip(data, axis=0):
    return torch.flip(data, _axes(axis))


@register("tile", nin=1)
def _tile(data, reps=None):
    return torch.tile(data, tuple(int(r) for r in reps))


@register("repeat", nin=1)
def _repeat(data, repeats=1, axis=None):
    """``numpy.repeat``: each element ``repeats`` times along ``axis``, the
    flattened array when ``axis`` is None."""
    return torch.repeat_interleave(data, int(repeats),
                                   None if axis is None else int(axis))


@register("broadcast_axis", nin=1, aliases=["broadcast_axes"])
def _broadcast_axis(data, axis=None, size=None):
    tgt = list(data.shape)
    for a, s in zip(_axes(axis), _axes(size)):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("slice_like", nin=2)
def _slice_like(lhs, rhs, axes=None):
    idx = [slice(None)] * lhs.ndim
    for a in (axes if axes else range(lhs.ndim)):
        idx[a] = slice(0, rhs.shape[a])
    return lhs[tuple(idx)]


@register("split_v2", nin=1, nout=-1, aliases=["_split_v2"])
def _split_v2(data, indices_or_sections=1, axis=0, squeeze_axis=False):
    """``numpy.split``: an int splits into that many equal parts, a
    sequence at those indices; one part comes back as an array."""
    ios = indices_or_sections
    if isinstance(ios, int):
        if data.shape[axis] % ios:
            raise ValueError(f"axis {axis} of size {data.shape[axis]} does "
                             f"not split into {ios} equal parts")
        parts = torch.tensor_split(data, ios, dim=axis)
    else:
        parts = torch.tensor_split(data, [int(i) for i in ios], dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("depth_to_space", nin=1)
def _depth_to_space(data, block_size=1):
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", nin=1)
def _space_to_depth(data, block_size=1):
    """The inverse of ``depth_to_space``: block-h then block-w lead the new
    depth (reference matrix_op-inl.h SpaceToDepth)."""
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag", nin=1)
def _diag(data, k=0, axis1=0, axis2=1):
    if data.ndim == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, int(k), int(axis1), int(axis2))


@register("khatri_rao", nin=None)
def _khatri_rao(args):
    """Column-wise Kronecker product of ``[r_i, c]`` matrices:
    ``[prod(r_i), c]``."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            (-1,) + tuple(out.shape[1:]))
    return out


# ---------------------------------------------------------------------------
# gather and scatter (reference indexing_op.cc)
# ---------------------------------------------------------------------------
def _wrap_negative(idx, size):
    return torch.where(idx < 0, idx + size, idx)


@register("batch_take", nin=2)
def _batch_take(a, indices):
    """``a[i, indices[i]]`` for each row ``i``."""
    idx = _wrap_negative(indices.to(torch.int64), a.shape[1])
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _nd_index(indices):
    return tuple(indices.to(torch.int64))


def _linear_index(indices, lead):
    """The row of each position that ``indices`` ([M, ...]) names in a
    table of the ``lead`` dims (negative indices count from the end), and
    whether it lies inside."""
    idx = indices.to(torch.int64)
    lin = torch.zeros(idx.shape[1:], dtype=torch.int64, device=idx.device)
    ok = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for k, size in enumerate(lead):
        i = _wrap_negative(idx[k], size)
        ok &= (i >= 0) & (i < size)
        lin = lin * size + i
    return lin, ok


def _backward_gather_nd(data, indices, shape):
    """The rows of ``data`` added into a zero array of ``shape`` at the
    positions ``indices`` ([M, ...]) names: duplicates add, positions
    outside ``shape`` add nothing.  The positions become row ids of a
    ``[prod(shape[:M]), prod(shape[M:])]`` table, so fp32 and bf16 go
    through :func:`~mxnet_tpu_torch.ops.embedding.embedding_backward`,
    whose CUDA kernel adds each row's duplicates in one fixed order (the
    same bits on every run; no atomics).  Other dtypes add exactly in any
    order (``index_put_``)."""
    from .embedding import embedding_backward
    shape = tuple(int(s) for s in shape)
    if data.device.type == "meta":
        return torch.empty(shape, dtype=data.dtype, device="meta")
    lead, rest = shape[:indices.shape[0]], shape[indices.shape[0]:]
    rows, width = int(np.prod(lead)), int(np.prod(rest))
    lin, ok = _linear_index(indices, lead)
    lin = torch.where(ok, lin, rows).reshape(-1)  # past the table: dropped
    src = data.reshape(-1, width)
    if data.dtype in (torch.float32, torch.bfloat16):
        return embedding_backward(lin, src, rows).reshape(shape)
    out = torch.zeros((rows + 1, width), dtype=data.dtype,
                      device=data.device)
    return out.index_put_((lin,), src, accumulate=True)[:rows].reshape(shape)


def _scatter_set(base, indices, data):
    """``base`` with the rows of ``data`` written at the positions
    ``indices`` names.  Of duplicate positions the last write wins, as in
    XLA's scatter, and only it takes a gradient; the writes add into
    zeros (each position gets one value and exact zeros), so every run
    gives the same bits."""
    m = indices.shape[0]
    lead = tuple(base.shape[:m])
    lin, _ = _linear_index(indices, lead)
    flat = lin.reshape(-1)
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((int(np.prod(lead)),), -1, dtype=torch.int64,
                      device=flat.device).scatter_reduce(0, flat, order,
                                                         "amax")
    won = (last[flat] == order).reshape(lin.shape)
    grow = (1,) * (base.ndim - m)
    idx = _nd_index(indices)
    added = torch.zeros_like(base).index_put(
        idx, torch.where(won.reshape(won.shape + grow), data.to(base.dtype),
                         0), accumulate=True)
    covered = torch.zeros(lead, dtype=torch.int32, device=base.device
                          ).index_put(idx, won.to(torch.int32),
                                      accumulate=True)
    return torch.where(covered.reshape(lead + grow) > 0, added, base)


def _gather_nd_grad(params, inputs, outputs, out_grads):
    data, indices = inputs
    return [_backward_gather_nd(out_grads[0], indices, data.shape), None]


@register("gather_nd", nin=2, grad=_gather_nd_grad)
def _gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``; its gradient adds
    duplicates in a fixed order (:func:`_backward_gather_nd`)."""
    return data[_nd_index(indices)]


@register("scatter_nd", nin=2)
def _scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return _scatter_set(out, indices, data)


@register("_scatter_set_nd", nin=3)
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    return _scatter_set(lhs, indices, rhs)


@register("_backward_gather_nd", nin=2, differentiable=False)
def _backward_gather_nd_op(data, indices, shape=None):
    """Accumulating scatter (reference GatherNDBackward): duplicate indices
    add, where ``scatter_nd``'s duplicate writes leave one of them."""
    return _backward_gather_nd(data, indices, shape)


@register("boolean_mask", nin=2, aliases=["_contrib_boolean_mask"])
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's shape depends on the mask's values, so the op runs
    eagerly only (the JAX package's is eager-only too): on ``meta``
    tensors (symbol shape inference) and inside a CUDA graph capture it
    raises ``MXNetError`` rather than keep one mask's shape."""
    axis = int(axis)
    if data.device.type == "meta" or index.device.type == "meta":
        raise MXNetError("boolean_mask: the output shape depends on the "
                         "mask's values; it has no shape inference")
    if data.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError("boolean_mask: the output shape depends on the "
                         "mask's values, so it cannot run inside a CUDA "
                         "graph (a hybridized block, an Executor); call "
                         "it eagerly")
    mask = index.reshape(-1) != 0
    if mask.shape[0] != data.shape[axis]:
        raise ValueError(
            f"boolean_mask: index length {mask.shape[0]} does not match "
            f"data.shape[{axis}] = {data.shape[axis]}")
    return torch.index_select(data, axis, torch.nonzero(mask).reshape(-1))


# ---------------------------------------------------------------------------
# sequence ops (reference sequence_mask.cc, sequence_last.cc,
# sequence_reverse.cc): time on ``axis``, batch on the other of axes 0/1
# ---------------------------------------------------------------------------
def _sequence_args(data, sequence_length, use_sequence_length):
    if isinstance(data, (list, tuple)):
        data, sequence_length = (data[0], data[1] if len(data) == 2
                                 else None)
    if not attr_truthy(use_sequence_length):
        sequence_length = None
    return data, sequence_length


@register("SequenceMask", nin=None, aliases=["sequence_mask"])
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    data, lengths = _sequence_args(data, sequence_length, use_sequence_length)
    if lengths is None:
        return data
    axis = int(axis)
    steps = torch.arange(data.shape[axis], device=data.device)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    lshape = [1] * data.ndim
    lshape[1 - axis] = data.shape[1 - axis]
    mask = steps.reshape(bshape) < lengths.reshape(lshape)
    return torch.where(mask, data, torch.tensor(float(value),
                                                dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", nin=None, aliases=["sequence_last"])
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    data, lengths = _sequence_args(data, sequence_length, use_sequence_length)
    axis = int(axis)
    steps = data.shape[axis]
    if lengths is None:
        return torch.select(data, axis, steps - 1)
    idx = torch.remainder(lengths.to(torch.int64) - 1, steps)
    lshape = [1] * data.ndim
    lshape[1 - axis] = data.shape[1 - axis]
    size = list(data.shape)
    size[axis] = 1
    idx = idx.reshape(lshape).expand(size)
    return torch.gather(data, axis, idx).squeeze(axis)


@register("SequenceReverse", nin=None, aliases=["sequence_reverse"])
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Each sequence's first ``length`` steps reversed in place, the
    padding after them kept (the batch on axis 1 of the time-major
    data)."""
    data, lengths = _sequence_args(data, sequence_length, use_sequence_length)
    axis = int(axis)
    if lengths is None:
        return torch.flip(data, (axis,))
    moved = torch.movedim(data, axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    slen = lengths.to(torch.int64)[None, :]
    rev = torch.where(steps < slen, slen - 1 - steps, steps)
    rev = rev.reshape(rev.shape + (1,) * (moved.ndim - 2)).expand(
        moved.shape)
    return torch.movedim(torch.gather(moved, 0, rev), 0, axis)


# ---------------------------------------------------------------------------
# ordering (reference ordering_op.cc).  Ties keep the lower index first, as
# lax.top_k and jnp's stable sort do; a descending sort/argsort is the
# ascending one reversed, so its ties come out in reverse index order.
# ---------------------------------------------------------------------------
@register("topk", nin=1, nout=-1, differentiable=False)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    axis = int(axis) % data.ndim
    vals, idxs = torch.sort(data, dim=axis, descending=not
                            attr_truthy(is_ascend), stable=True)
    vals, idxs = vals.narrow(axis, 0, int(k)), idxs.narrow(axis, 0, int(k))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs.to(dtype_torch(dtype))
    if ret_typ == "both":
        return vals, idxs.to(dtype_torch(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idxs, 1)
    raise ValueError(f"topk: unknown ret_typ {ret_typ!r}")


@register("sort", nin=1, differentiable=False)
def _sort(data, axis=-1, is_ascend=True):
    s = torch.sort(data, dim=int(axis), stable=True).values
    return s if attr_truthy(is_ascend) else torch.flip(s, (int(axis),))


@register("argsort", nin=1, differentiable=False)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(data, dim=int(axis), stable=True)
    if not attr_truthy(is_ascend):
        idx = torch.flip(idx, (int(axis),))
    return idx.to(dtype_torch(dtype))


def _arg_reduce(fn, data, axis, keepdims):
    """float32 indices (the reference's convention), the first extremum."""
    if axis is None:
        return fn(data.reshape(-1)).to(torch.float32)
    out = fn(data, dim=int(axis), keepdim=attr_truthy(keepdims))
    return out.to(torch.float32)


@register("argmax", nin=1, differentiable=False)
def _argmax(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmax, data, axis, keepdims)


@register("argmin", nin=1, differentiable=False)
def _argmin(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmin, data, axis, keepdims)


@register("argmax_channel", nin=1, differentiable=False)
def _argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("shape_array", nin=1, differentiable=False)
def _shape_array(data):
    # int32: the JAX package's index width with x64 off
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array", nin=1, differentiable=False)
def _size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


# ---------------------------------------------------------------------------
# more creation ops (reference init_op.cc) and their other names
# ---------------------------------------------------------------------------
@register("_eye", nin=0, differentiable=False)
def _eye_op(N=0, M=0, k=0, dtype="float32", device=None):
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(m, device=device)[None, :]
    return (cols - rows == int(k)).to(dtype_torch(dtype))


@register("_linspace", nin=0, differentiable=False)
def _linspace_op(start=0, stop=1, num=50, endpoint=True, dtype="float32",
                 device=None):
    vals = np.linspace(float(start), float(stop), int(num),
                       endpoint=attr_truthy(endpoint), dtype=np.float32)
    return torch.from_numpy(vals).to(device=device, dtype=dtype_torch(dtype))


for _canon, _names in {"_zeros": ("_npi_zeros", "_zeros_without_dtype"),
                       "_ones": ("_npi_ones",), "_full": ("_npi_full",),
                       "_arange": ("_npi_arange",), "_eye": ("_npi_eye",),
                       "_linspace": ("_npi_linspace",)}.items():
    for _name in _names:
        alias(_canon, _name)
