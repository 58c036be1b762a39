"""Pipeline parallelism over the ``pp`` mesh axis, SPMD GPipe
(counterpart of ``mxnet_tpu/parallel/pipeline.py``).

Every stage runs the same body (:func:`~.collectives.shard_map`); each
stage's parameters are one slice of tensors stacked along a leading
``n_stages`` dim that is sharded over ``pp``; activations move one stage
per step with :func:`~.collectives.ppermute`.  The GPipe schedule (``n_micro
+ n_stages - 1`` steps: fill, steady state, drain) runs in full at every
stage, bubbles included, as the JAX package's ``lax.scan`` does, and
autograd differentiates through it.  Every stage maps activations of one
shape to the same shape.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import collectives as C
from .mesh import PartitionSpec as P

__all__ = ["PipelineStage", "spmd_pipeline", "stack_stage_params"]


def stack_stage_params(per_stage_params):
    """``[stage0_tree, stage1_tree, ...]`` -> one tree whose tensors have a
    leading ``n_stages`` dim (the dim :func:`spmd_pipeline` shards)."""
    leaves = [pytree.tree_flatten(t)[0] for t in per_stage_params]
    spec = pytree.tree_flatten(per_stage_params[0])[1]
    return pytree.tree_unflatten(
        [torch.stack(group) for group in zip(*leaves)], spec)


class PipelineStage:
    """A pipeline-ready stage: a pure ``fn(params, h) -> h`` and its
    params."""

    def __init__(self, fn: Callable, params: Any):
        self.fn = fn
        self.params = params

    def __call__(self, h):
        return self.fn(self.params, h)


def spmd_pipeline(stage_fn: Callable, stage_params, x, mesh, axis: str = "pp",
                  n_microbatches: Optional[int] = None):
    """``n_stages`` copies of ``stage_fn`` as a GPipe pipeline.

    ``stage_fn``: ``(params_i, h) -> h`` preserving h's shape;
    ``stage_params``: a tree whose tensors have a leading ``n_stages`` dim
    (:func:`stack_stage_params`); ``x``: ``[batch, ...]``, split into
    ``n_microbatches`` (default ``n_stages``) along dim 0.  Returns the
    last stage's ``[batch, ...]`` output."""
    n_stages = mesh.axis_size(axis)
    n_micro = int(n_microbatches or n_stages)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by microbatches {n_micro}")
    xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    leaves, spec = pytree.tree_flatten(stage_params)
    last = n_stages - 1

    def body(xm_l, *leaf_lists):
        stage = C.axis_index(xm_l, axis)
        params = [pytree.tree_unflatten([lst[p][0] for lst in leaf_lists],
                                        spec) for p in range(len(xm_l))]
        state = [torch.zeros_like(t[0]) for t in xm_l]
        banked = [[None] * n_micro for _ in xm_l]
        for t in range(n_micro + n_stages - 1):
            out = []
            for p, st in enumerate(stage):
                inp = xm_l[p][min(t, n_micro - 1)] if st == 0 else state[p]
                out.append(stage_fn(params[p], inp))
                if st == last and t >= last:
                    banked[p][t - last] = out[p]
            if n_stages > 1:
                state = C.ppermute(out, axis, perm)
        # only the last stage holds outputs; the psum hands them to all
        res = [torch.stack(banked[p]) if st == last
               else torch.zeros_like(xm_l[p]) for p, st in enumerate(stage)]
        return C.psum(res, axis)

    fn = C.shard_map(body, mesh, (P(),) + (P(axis),) * len(leaves), P())
    out = fn(xm, *leaves)
    return out.reshape((b,) + tuple(out.shape[2:]))
