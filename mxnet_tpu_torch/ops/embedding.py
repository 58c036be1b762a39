"""The Embedding lookup with a deterministic backward.

The JAX package's Embedding gradient is XLA's scatter-add, which repeats
bit for bit; ``F.embedding``'s CUDA backward adds in an order that varies
from run to run.  :class:`_EmbeddingLookup` is the one autograd Function
both training call sites use (the Gluon ``Embedding`` and the registry's
``Embedding``, through :func:`mxnet_tpu_torch.ops.nn.embedding`): its
forward is the row gather, its backward :func:`embedding_backward`.  On a
CUDA tensor that launches the hand-written kernel
``csrc/embedding_bwd.cu`` (a stable sort of the ids, then one block per
segment of equal ids and 32-column tile, each sum in sorted order); on a
CPU tensor it runs :func:`_reference_embedding_bwd`, the plain version
(``zeros().index_add_``).
"""
from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from .. import _graphs
from ..base import MXNetError
from . import _build

__all__ = ["embedding_backward", "embedding_lookup"]

# Launches of csrc/embedding_bwd.cu made by embedding_backward (the count
# shows that a run went through the kernel; nothing else touches it)
embedding_bwd_launches = 0
_graphs.count_launches(sys.modules[__name__], "embedding_bwd_launches")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _valid_ids(ids, vocab: int):
    """The forward's id rules: [-V, 0) counts from the end; any other id
    outside [0, V) is invalid.  Returns (wrapped ids, valid mask)."""
    idx = ids.long()
    idx = torch.where(idx < 0, idx + vocab, idx)
    return idx, (idx >= 0) & (idx < vocab)


def _reference_embedding_bwd(ids, dy, vocab: int):
    """Plain version: the rows of ``dy`` ([..., D]) added into a zero
    ``[vocab, D]`` table at the valid ``ids``, in ``dy``'s dtype.  fp32
    adds with ``index_add_``; a narrower dtype adds row by row in position
    order, each add rounded, as the JAX package's scatter-add (and
    PyTorch's CPU backward) does.  The kernel sums in fp32 and rounds
    once, so on the card it is held against this function on fp32
    copies."""
    d = dy.shape[-1]
    idx, ok = _valid_ids(ids.reshape(-1), vocab)
    idx, rows = idx[ok], dy.reshape(-1, d)[ok]
    dw = torch.zeros((vocab, d), dtype=dy.dtype, device=dy.device)
    if dy.dtype == torch.float32 or idx.numel() == 0:
        return dw.index_add_(0, idx, rows)
    # the k-th occurrence of every id in one vectorised add, k = 0, 1, ...
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    starts = torch.ones_like(sorted_idx, dtype=torch.bool)
    starts[1:] = sorted_idx[1:] != sorted_idx[:-1]
    pos = torch.arange(idx.numel(), device=idx.device)
    run_start = torch.cummax(torch.where(starts, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    for k in range(int(rank.max()) + 1):
        at = rank == k
        dw[idx[at]] = dw[idx[at]] + rows[at]
    return dw


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("embedding_bwd")
        lib.embedding_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.embedding_bwd.restype = ctypes.c_int
        lib.embedding_bwd_keys.argtypes = [ctypes.c_longlong]
        lib.embedding_bwd_keys.restype = ctypes.c_longlong
        lib.embedding_bwd_error_string.argtypes = [ctypes.c_int]
        lib.embedding_bwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _embedding_bwd_cuda(ids, dy, vocab: int):
    global embedding_bwd_launches
    d = dy.shape[-1]
    if dy.dtype not in _DTYPE_CODES:
        raise MXNetError(f"embedding_backward: the kernel takes float32 or "
                         f"bfloat16 gradients, got {dy.dtype}")
    if ids.device != dy.device:
        raise MXNetError(f"embedding_backward: ids on {ids.device}, the "
                         f"gradient on {dy.device}")
    ids = ids.reshape(-1).long().contiguous()
    rows = dy.reshape(-1, d).contiguous()
    n = ids.numel()
    if rows.shape[0] != n:
        raise MXNetError(f"embedding_backward: {n} ids for "
                         f"{rows.shape[0]} gradient rows")
    dw = torch.empty((vocab, d), dtype=dy.dtype, device=dy.device)
    if n == 0:
        return dw.zero_()
    lib = _kernel()
    p = lib.embedding_bwd_keys(n)
    with torch.cuda.device(dy.device):
        keys = torch.empty(p, dtype=torch.int64, device=dy.device)
        err = lib.embedding_bwd(
            ids.data_ptr(), n, rows.data_ptr(), dw.data_ptr(), vocab, d,
            _DTYPE_CODES[dy.dtype], keys.data_ptr(), p,
            torch.cuda.current_stream(dy.device).cuda_stream)
    if err:
        raise MXNetError("embedding_bwd launch failed: "
                         + lib.embedding_bwd_error_string(err).decode())
    embedding_bwd_launches += 1
    return dw


def embedding_backward(ids, dy, vocab: int):
    """The gradient of ``weight[ids]`` for a ``[vocab, D]`` table, given the
    output's gradient ``dy`` ([*ids.shape, D]), in ``dy``'s dtype; invalid
    ids add nothing.  CUDA tensors launch ``csrc/embedding_bwd.cu`` (the
    same bits on every run), CPU and ``meta`` tensors run the plain
    version."""
    if dy.device.type in ("cpu", "meta"):
        return _reference_embedding_bwd(ids, dy, vocab)
    if dy.device.type != "cuda":
        raise MXNetError(f"embedding_backward: no kernel for device "
                         f"{dy.device}")
    return _embedding_bwd_cuda(ids, dy, vocab)


class _EmbeddingLookup(torch.autograd.Function):
    """``weight[safe_ids]`` with :func:`embedding_backward` as its
    gradient; ``ids`` keeps the caller's ids, whose invalid entries the
    backward skips."""

    @staticmethod
    def forward(ctx, ids, safe_ids, weight):
        ctx.save_for_backward(ids)
        ctx.vocab = weight.shape[0]
        return F.embedding(safe_ids, weight)

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        return None, None, _EmbeddingGrad.apply(ids, dy, ctx.vocab)


class _EmbeddingGrad(torch.autograd.Function):
    """:func:`embedding_backward` as a node of its own, so that
    ``autograd.grad(create_graph=True)`` differentiates it with the kernel
    still on the path: the table's gradient is linear in ``dy``, and its
    derivative is the lookup of the cotangent at the valid ids (zero at
    the invalid ones), whose own gradient is the kernel again."""

    @staticmethod
    def forward(ctx, ids, dy, vocab: int):
        ctx.save_for_backward(ids)
        return embedding_backward(ids, dy, vocab)

    @staticmethod
    def backward(ctx, ddw):
        ids, = ctx.saved_tensors
        rows, ok = embedding_lookup(ids, ddw)
        return None, torch.where(ok.unsqueeze(-1), rows, 0), None


def embedding_lookup(ids, weight):
    """Rows of ``weight`` at ``ids`` (any shape), an invalid id reading
    row 0, and the mask of the valid ids.  A floating table is
    differentiable through :class:`_EmbeddingLookup`."""
    idx, ok = _valid_ids(ids, weight.shape[0])
    safe = torch.where(ok, idx, 0)
    if not weight.is_floating_point():
        return F.embedding(safe, weight), ok
    return _EmbeddingLookup.apply(ids, safe, weight), ok
