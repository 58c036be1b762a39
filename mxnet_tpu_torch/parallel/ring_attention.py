"""Sequence parallelism: ring attention and Ulysses (counterpart of
``mxnet_tpu/parallel/ring_attention.py``), over the ``sp`` axis of a
:class:`~.mesh.DeviceMesh`.

* **Ring**: each position keeps its query chunk while the K/V chunks go
  round the ring (:func:`~.collectives.ppermute`), each step folding one
  chunk into the running online-softmax state (m, l, acc) with causal
  masks at global row and column offsets.  The port rotates n - 1 times
  (the JAX body's last rotation returns the chunks home and feeds
  nothing), and skips a chunk that lies wholly above the causal
  diagonal: every row has its diagonal chunk at step 0, so such a chunk
  would add exactly zero.
* **Ulysses**: :func:`~.collectives.all_to_all` re-shards
  ``[B, H, S/n, D]`` to ``[B, H/n, S, D]``, runs the plain
  :func:`~mxnet_tpu_torch.ops.attention.attention_reference` on whole
  sequences, as the JAX body does, and re-shards back.

Both are grouped-query aware: K/V may carry H_kv < H heads.  The
``*_local`` functions are the lockstep bodies (lists of the positions'
shards, see :func:`~.collectives.shard_map`); :func:`ring_attention` and
:func:`ulysses_attention` take global ``[B, H, S, D]`` tensors, shard the
sequence over ``seq_axis`` (and the batch over ``dp`` when the mesh has it
and B divides), and return the global output.  Their gradient recomputes
the sequence-parallel forward at backward time and differentiates that,
as the JAX package's registered gradient does, so no chunk's scores are
kept from the forward to the backward.  The registered ops
``_ring_attention`` and ``_ulysses_attention`` are the same functions in
``mx.nd``/``mx.sym``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..base import MXNetError, attr_truthy
from ..ops.attention import attention_reference
from ..ops.registry import register
from . import collectives as C
from .mesh import PartitionSpec as P, current_mesh

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_local",
           "ulysses_attention_local"]

_MASK = -1e30


def _chunk_attention(q, k_chunk, v_chunk, sm_scale, rows0, cols0, causal):
    """One flash-style partial of the local queries against one K/V chunk
    with global-position masking: (chunk max, exp-sum, weighted V), the
    einsums grouped per KV head."""
    b, h, sq, d = q.shape
    hkv = k_chunk.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg,
                     k_chunk.to(q.dtype)).float() * sm_scale
    if causal:
        rows = rows0 + torch.arange(sq, device=q.device)
        cols = cols0 + torch.arange(k_chunk.shape[2], device=q.device)
        s = torch.where(rows[:, None] >= cols[None, :], s,
                        s.new_full((), _MASK))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v_chunk.float())
    merge = lambda t: t.reshape((b, h) + t.shape[3:])
    return merge(m), merge(l), merge(o)


def ring_attention_local(q, k, v, axis_name: str = "sp", causal: bool = False,
                         sm_scale: Optional[float] = None):
    """The ring body: ``q``/``k``/``v`` the positions' local sequence
    chunks ``[B, H, S/n, D]``; returns the local outputs."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q[0].shape[-1])
    rank = C.axis_index(q, axis_name)
    n = max(rank) + 1
    s_loc = q[0].shape[2]
    perm = [(i, (i + 1) % n) for i in range(n)]
    qf = [t.float() for t in q]
    acc = [t.new_zeros(t.shape) for t in qf]
    m = [t.new_full(t.shape[:3] + (1,), _MASK) for t in qf]
    l = [t.new_zeros(t.shape[:3] + (1,)) for t in qf]
    for i in range(n):
        for p, r in enumerate(rank):
            src = (r - i) % n
            if causal and src > r:
                continue
            cm, cl, co = _chunk_attention(qf[p], k[p], v[p], sm_scale,
                                          r * s_loc, src * s_loc, causal)
            m_new = torch.maximum(m[p], cm)
            alpha, beta = torch.exp(m[p] - m_new), torch.exp(cm - m_new)
            l[p] = l[p] * alpha + cl * beta
            acc[p] = acc[p] * alpha + co * beta
            m[p] = m_new
        if i < n - 1:
            k = C.ppermute(k, axis_name, perm)
            v = C.ppermute(v, axis_name, perm)
    # a row with no key yet (l == 0) outputs 0
    return [(a / torch.clamp_min(s, 1e-30)).to(t.dtype)
            for a, s, t in zip(acc, l, q)]


def ulysses_attention_local(q, k, v, axis_name: str = "sp",
                            causal: bool = False,
                            sm_scale: Optional[float] = None):
    """The Ulysses body: heads and sequence exchanged with all_to_all,
    plain attention on whole sequences for the local heads, exchanged
    back.  H must divide by the axis size.  With GQA, K/V cross at H_kv
    heads when H_kv divides the axis size and are repeated after the
    exchange, else expanded before it."""
    n = max(C.axis_index(q, axis_name)) + 1
    h, hkv = q[0].shape[1], k[0].shape[1]
    rep = h // hkv
    if rep > 1 and hkv % n:
        k = [t.repeat_interleave(rep, dim=1) for t in k]
        v = [t.repeat_interleave(rep, dim=1) for t in v]
        rep = 1
    qh = C.all_to_all(q, axis_name, split_axis=1, concat_axis=2)
    kh = C.all_to_all(k, axis_name, split_axis=1, concat_axis=2)
    vh = C.all_to_all(v, axis_name, split_axis=1, concat_axis=2)
    if rep > 1:
        kh = [t.repeat_interleave(rep, dim=1) for t in kh]
        vh = [t.repeat_interleave(rep, dim=1) for t in vh]
    out = [attention_reference(a, b, c, causal=causal, sm_scale=sm_scale)
           for a, b, c in zip(qh, kh, vh)]
    return C.all_to_all(out, axis_name, split_axis=2, concat_axis=1)


def _driver(local_fn, mesh, seq_axis, causal, sm_scale, q, k, v):
    """``local_fn`` over the mesh on global tensors: the sequence over
    ``seq_axis``, the batch over ``dp`` where the mesh has it and B
    divides."""
    dp = mesh.axis_size("dp")
    batch = "dp" if dp > 1 and q.shape[0] % dp == 0 else None
    spec = P(batch, None, seq_axis, None)
    body = functools.partial(local_fn, axis_name=seq_axis, causal=causal,
                             sm_scale=sm_scale)
    return C.shard_map(body, mesh, spec, spec)(q, k, v)


class _Recomputed(torch.autograd.Function):
    """``run(q, k, v)`` whose backward runs it again under autograd and
    differentiates that: nothing of the forward is kept but its inputs."""

    @staticmethod
    def forward(ctx, q, k, v, run):
        ctx.run = run
        ctx.save_for_backward(q, k, v)
        with torch.no_grad():
            return run(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.run(*ins)
            grads = torch.autograd.grad(out, ins, dout)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def _seq_parallel(local_fn, q, k, v, mesh, seq_axis, causal, sm_scale):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("sequence-parallel attention needs a mesh (pass "
                         "mesh= or enter one with `with mesh:`)")
    if seq_axis not in mesh.axes:
        raise MXNetError(f"{mesh!r} has no axis {seq_axis!r}")
    run = functools.partial(_driver, local_fn, mesh, seq_axis,
                            attr_truthy(causal),
                            None if sm_scale is None else float(sm_scale))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Recomputed.apply(q, k, v, run)
    return run(q, k, v)


@register("_ring_attention", nin=3)
def _ring_attention_op(q, k, v, mesh=None, seq_axis: str = "sp",
                       causal: bool = False, sm_scale=None):
    return _seq_parallel(ring_attention_local, q, k, v, mesh, seq_axis,
                         causal, sm_scale)


@register("_ulysses_attention", nin=3)
def _ulysses_attention_op(q, k, v, mesh=None, seq_axis: str = "sp",
                          causal: bool = False, sm_scale=None):
    return _seq_parallel(ulysses_attention_local, q, k, v, mesh, seq_axis,
                         causal, sm_scale)


def _dispatch(name, op, q, k, v, mesh, seq_axis, causal, sm_scale):
    from ..ndarray.ndarray import NDArray, invoke
    params = {"mesh": mesh, "seq_axis": seq_axis, "causal": causal,
              "sm_scale": sm_scale}
    if any(isinstance(t, NDArray) for t in (q, k, v)):
        return invoke(name, [q, k, v], params)
    return op(q, k, v, **params)


def ring_attention(q, k, v, mesh=None, seq_axis: str = "sp",
                   causal: bool = False, sm_scale: Optional[float] = None):
    """Global-view ring attention over ``[B, H, S, D]`` (K/V may have
    fewer heads); NDArray inputs go through the registry (autograd
    records the call)."""
    return _dispatch("_ring_attention", _ring_attention_op, q, k, v, mesh,
                     seq_axis, causal, sm_scale)


def ulysses_attention(q, k, v, mesh=None, seq_axis: str = "sp",
                      causal: bool = False, sm_scale: Optional[float] = None):
    """Global-view Ulysses attention over ``[B, H, S, D]``."""
    return _dispatch("_ulysses_attention", _ulysses_attention_op, q, k, v,
                     mesh, seq_axis, causal, sm_scale)
