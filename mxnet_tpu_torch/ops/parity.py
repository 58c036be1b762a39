"""The reference's other op names, and the small ops that complete the
registry.

Counterpart of ``mxnet_tpu/ops/parity.py``:

* names the reference registers beside ops the port already has: the
  element-wise comparison and logical spellings over the ``broadcast_*``
  ops (``equal``, ``_lesser`` ...), ``_grad_add``, the ``_scatter_*_scalar``
  names over the dense scalar ops, ``CuDNNBatchNorm``, ``_np_copy`` and the
  ``_npx_relu``/``_npx_sigmoid`` spellings.  An alias is the same
  operator, so its outputs' dtypes are the canonical op's;
* ``UpSampling`` (nearest, and bilinear over its weight input),
  ``col2im``, ``_histogram``, ``arange_like``, ``amp_cast`` and
  ``amp_multicast``, ``cast_storage``, ``_square_sum``,
  ``_sparse_retain`` and ``_contrib_getnnz`` on dense arrays,
  ``_identity_with_attr_like_rhs``, ``IdentityAttachKLSparseReg`` with its
  gradient, ``_rnn_param_concat`` and the ``_npi_``/``_npx_`` ops
  (``identity``, ``indices``, ``share_memory``, ``reshape``,
  ``constraint_check``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import attr_truthy, dtype_torch
from .nn import im2col
from .registry import alias, register

__all__ = ["ALIASES"]

# -- element-wise names over the broadcast ops (the reference registers both
#    spellings of the same kernels, elemwise_binary_op_logic.cc)
ALIASES = {
        "broadcast_equal": ("_equal", "equal"),
        "broadcast_not_equal": ("_not_equal", "not_equal"),
        "broadcast_greater": ("_greater", "greater"),
        "broadcast_greater_equal": ("_greater_equal", "greater_equal"),
        "broadcast_lesser": ("_lesser", "less", "lesser"),
        "broadcast_lesser_equal": ("_lesser_equal", "less_equal",
                                   "lesser_equal"),
        "broadcast_mod": ("_mod", "mod"),
        "broadcast_hypot": ("_hypot",),
        "broadcast_logical_and": ("_logical_and", "logical_and"),
        "broadcast_logical_or": ("_logical_or", "logical_or"),
        "broadcast_logical_xor": ("_logical_xor", "logical_xor"),
        "broadcast_add": ("_grad_add",),
        # sparse-storage write variants; dense compute is the scalar op
        "_plus_scalar": ("_scatter_plus_scalar",),
        "_minus_scalar": ("_scatter_minus_scalar",),
        "copy": ("_np_copy",),
        "relu": ("_npx_relu",),
        "sigmoid": ("_npx_sigmoid",),
        "BatchNorm": ("CuDNNBatchNorm",)}
for _canon, _names in ALIASES.items():
    for _name in _names:
        alias(_canon, _name)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
@register("_npi_identity", nin=0, differentiable=False)
def _identity_mat(shape=(), dtype="float32", device=None):
    n = shape[0] if isinstance(shape, (tuple, list)) else int(shape)
    return torch.eye(int(n), dtype=dtype_torch(dtype), device=device)


@register("_npi_indices", nin=0, differentiable=False)
def _indices(dimensions=(), dtype="int32", device=None):
    dt = dtype_torch(dtype)
    return torch.stack(torch.meshgrid(
        *[torch.arange(int(d), dtype=dt, device=device) for d in dimensions],
        indexing="ij"))


@register("arange_like", nin=1, differentiable=False,
          aliases=["_contrib_arange_like", "_npx_arange_like"])
def _arange_like(data, start=0.0, step=1.0, repeat=1, ctx=None, axis=None):
    """``start + step · (i // repeat)`` over ``data``'s elements (or over
    its ``axis``), in ``data``'s dtype (init_op.cc _contrib_arange_like)."""
    if axis is None:
        n, shape = data.numel(), tuple(data.shape)
    else:
        n = data.shape[int(axis)]
        shape = (n,)
    i = torch.arange(n, device=data.device) // max(int(repeat), 1)
    out = float(start) + float(step) * i.to(torch.float32)
    return out.reshape(shape).to(data.dtype)


# ---------------------------------------------------------------------------
# histogram (tensor/histogram.cc)
# ---------------------------------------------------------------------------
@register("_histogram", nin=1, nout=2, differentiable=False,
          aliases=["histogram"])
def _histogram(data, bin_cnt=10, range=None):
    """``(counts int32 [bin_cnt], edges float32 [bin_cnt + 1])`` over
    ``range``, or over ``[min, max]`` of the data (computed on the
    device).  Counts add with ``index_put_``, exact in any order."""
    bins = int(bin_cnt)
    flat = data.reshape(-1).to(torch.float32)
    if range is not None:
        lo = torch.tensor(float(range[0]), device=data.device)
        hi = torch.tensor(float(range[1]), device=data.device)
    else:
        lo, hi = flat.min(), flat.max()
    steps = torch.arange(bins + 1, device=data.device, dtype=torch.float32)
    edges = lo + (hi - lo) / bins * steps
    edges[-1] = hi
    idx = torch.clamp(((flat - lo) / (hi - lo + 1e-37) * bins).to(
        torch.int32), 0, bins - 1).to(torch.int64)
    inside = ((flat >= lo) & (flat <= hi)).to(torch.int32)
    counts = torch.zeros(bins, dtype=torch.int32, device=data.device)
    return counts.index_put_((idx,), inside, accumulate=True), edges


# ---------------------------------------------------------------------------
# col2im: the adjoint of im2col (nn/im2col.cc)
# ---------------------------------------------------------------------------
@register("col2im", nin=1)
def _col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    """Patch columns ``[N, C·prod(kernel), L]`` summed back into an image
    of ``output_size``: the vector-Jacobian product of the linear
    :func:`~mxnet_tpu_torch.ops.nn.im2col`, which is col2im's definition
    (differentiable in turn while grad mode is on)."""
    nd = len(kernel)

    def ints(v, default):
        return tuple(int(e) for e in v) if v else (default,) * nd
    kernel = ints(kernel, 1)
    n, ck, _ = data.shape
    image = torch.zeros((n, ck // math.prod(kernel))
                        + tuple(int(s) for s in output_size),
                        dtype=data.dtype, device=data.device,
                        requires_grad=True)
    with torch.enable_grad():
        cols = im2col(image, kernel, ints(stride, 1), ints(dilate, 1),
                      ints(pad, 0))
    keep = torch.is_grad_enabled()
    out, = torch.autograd.grad(cols, image, data, create_graph=keep)
    return out


# ---------------------------------------------------------------------------
# AMP casts (tensor/amp_cast.cc)
# ---------------------------------------------------------------------------
_FLOAT_RANK = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
               torch.float64: 3}


@register("amp_cast", nin=1)
def _amp_cast(data, dtype="float32"):
    """Cast a floating input; an integer one passes through."""
    return data.to(dtype_torch(dtype)) if data.is_floating_point() else data


@register("amp_multicast", nin=None)
def _amp_multicast(args, num_outputs=0, cast_narrow=False):
    """Every floating input cast to the widest floating dtype among them
    (the narrowest with ``cast_narrow``)."""
    floats = [a.dtype for a in args if a.is_floating_point()]
    if not floats:
        return tuple(args)
    pick = min if attr_truthy(cast_narrow) else max
    target = pick(floats, key=lambda d: _FLOAT_RANK.get(d, 2))
    return tuple(a.to(target) if a.is_floating_point() else a for a in args)


@register("cast_storage", nin=1)
def _cast_storage(data, stype="default"):
    """Identity on dense arrays (sparse storage is not ported)."""
    return data


@register("_square_sum", nin=1, aliases=["square_sum"])
def _square_sum(data, axis=None, keepdims=False):
    sq = data * data
    keep = attr_truthy(keepdims)
    if axis is None:
        out = sq.sum()
        return out.reshape((1,) * data.ndim) if keep else out
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (int(axis),)
    return sq.sum(dim=axes, keepdim=keep)


@register("_sparse_retain", nin=2, differentiable=False)
def _sparse_retain_op(data, indices):
    """The rows listed in ``indices``; the other rows become zero (the
    dense meaning of the row_sparse op)."""
    idx = indices.to(torch.int64)
    out = torch.zeros_like(data)
    out[idx] = data[idx]
    return out


@register("_contrib_getnnz", nin=1, differentiable=False)
def _getnnz(data, axis=None):
    """The count of nonzeros (int32), in all or along ``axis``."""
    nz = data != 0
    if axis is None:
        return nz.sum().to(torch.int32)
    return nz.sum(dim=int(axis)).to(torch.int32)


# ---------------------------------------------------------------------------
# identities with a gradient of their own
# ---------------------------------------------------------------------------
def _id_lhs_grad(params, inputs, outputs, out_grads):
    return [out_grads[0], None]


@register("_identity_with_attr_like_rhs", nin=2, grad=_id_lhs_grad)
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


def _kl_sparse_grad(params, inputs, outputs, out_grads):
    """The output's gradient plus ``penalty`` times the KL sparsity
    gradient of the batch-mean activation (which stands in for the
    reference's moving average, as in the JAX package)."""
    data, = inputs
    target = float(params.get("sparseness_target", 0.1))
    penalty = float(params.get("penalty", 0.001))
    rho = data.mean(dim=0, keepdim=True).clamp(1e-6, 1 - 1e-6)
    reg = -target / rho + (1.0 - target) / (1.0 - rho)
    return [out_grads[0] + penalty * reg.to(data.dtype)]


@register("IdentityAttachKLSparseReg", nin=1, grad=_kl_sparse_grad)
def _identity_kl_sparse(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    return data


# ---------------------------------------------------------------------------
# UpSampling (nn/upsampling.cc)
# ---------------------------------------------------------------------------
@register("UpSampling", nin=None, aliases=["upsampling"])
def _upsampling(args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """``nearest``: every input repeated up to the first's size times
    ``scale``, then concatenated on the channels (or summed, with
    ``multi_input_mode='sum'``).  ``bilinear``: ``(data, weight)``, a
    transposed convolution with stride ``scale`` and one group per
    channel (the reference's Deconvolution form; the weight is
    ``[C, 1, k, k]`` with ``k = 2·scale − scale % 2``)."""
    scale = int(scale)
    if sample_type == "bilinear":
        data, weight = args
        return F.conv_transpose2d(data, weight.to(data.dtype), stride=scale,
                                  padding=scale // 2, groups=data.shape[1])
    size = args[0].shape[2] * scale
    outs = []
    for a in args:
        s = size // a.shape[2]
        outs.append(a.repeat_interleave(s, 2).repeat_interleave(s, 3))
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        return sum(outs[1:], outs[0])
    return torch.cat(outs, dim=1)


@register("_rnn_param_concat", nin=None)
def _rnn_param_concat(args, dim=0, num_args=1):
    """Concat for packed RNN parameters (rnn.cc)."""
    return torch.cat(list(args), dim=int(dim))


# ---------------------------------------------------------------------------
# _npx_reshape (np_matrix_op.cc:198 NumpyXReshapeInferShape) and the
# other _npi_/_npx_ ops
# ---------------------------------------------------------------------------
def _npx_reshape_target(src, target):
    """The target shape of ``src`` under the numpy-extension codes: -1
    infer, -2 copy, -3 skip a size-1 dim, -4 copy the rest, -5 merge two,
    -6 split one into the next two sizes (one may be -1)."""
    out, src_i, unknown, known = [], 0, -1, 1
    tgt = list(target)
    i = 0
    while i < len(tgt):
        d = tgt[i]
        if d == -1:
            if unknown >= 0:
                raise ValueError("only one dim can be inferred")
            unknown = len(out)
            out.append(-1)
            src_i += 1
        elif d == -2:
            out.append(src[src_i])
            known *= src[src_i]
            src_i += 1
        elif d == -3:
            if src[src_i] != 1:
                raise ValueError("-3 may only skip a size-1 dim")
            src_i += 1
        elif d == -4:
            while src_i < len(src):
                out.append(src[src_i])
                known *= src[src_i]
                src_i += 1
        elif d == -5:
            merged = src[src_i] * src[src_i + 1]
            src_i += 2
            out.append(merged)
            known *= merged
        elif d == -6:
            d0 = src[src_i]
            src_i += 1
            d1, d2 = tgt[i + 1], tgt[i + 2]
            i += 2
            if d1 == -1:
                d1 = d0 // d2
            elif d2 == -1:
                d2 = d0 // d1
            if d1 * d2 != d0:
                raise ValueError(f"split dims {d1},{d2} do not divide {d0}")
            out += [d1, d2]
            known *= d0
        else:
            out.append(int(d))
            known *= int(d)
            src_i += 1
        i += 1
    if unknown >= 0:
        out[unknown] = math.prod(src) // known
    return tuple(out)


def _reverse_spec(spec):
    """The spec reversed with each ``[-6, d1, d2]`` kept as one group, its
    two sizes swapped (the JAX package's deliberate reading; a raw
    reversal would misparse the split code)."""
    groups, i = [], 0
    spec = list(spec)
    while i < len(spec):
        if spec[i] == -6:
            groups.append([-6, spec[i + 2], spec[i + 1]])
            i += 3
        else:
            groups.append([spec[i]])
            i += 1
    return tuple(d for g in reversed(groups) for d in g)


@register("_npx_reshape", nin=1)
def _npx_reshape(data, newshape=(), reverse=False, order="C"):
    src = tuple(data.shape)
    if attr_truthy(reverse):
        out = tuple(reversed(_npx_reshape_target(
            tuple(reversed(src)), _reverse_spec(newshape))))
    else:
        out = _npx_reshape_target(src, tuple(newshape))
    return data.reshape(out)


@register("_npx_constraint_check", nin=1, differentiable=False)
def _constraint_check(data, msg="constraint violated"):
    """Whether every element of a boolean constraint holds (a 0-dim
    bool)."""
    return torch.all(data)


@register("_npi_share_memory", nin=2, differentiable=False)
def _share_memory(a, b):
    """Whether the two inputs are one array (no two distinct arrays share
    a buffer)."""
    return torch.tensor(a is b, device=a.device)
