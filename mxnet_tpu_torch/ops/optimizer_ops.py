"""Optimizer update ops: counterparts of ``sgd_update`` and
``sgd_mom_update`` in ``mxnet_tpu/ops/optimizer_ops.py``.

The JAX ops return new arrays; these update ``weight`` (and the momentum)
in place, which keeps one copy of each in device memory.  The arithmetic
is the same, in the same order: MXNet's rule
``mom = momentum·mom − lr·(rescale·g + wd·w)``, then ``w += mom``, which is
not ``torch.optim.SGD``'s.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update"]


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """``weight -= lr·g`` in place, ``g`` rescaled, clipped (when
    ``clip_gradient`` > 0) and decayed."""
    weight.sub_(lr * _prep(grad, rescale_grad, clip_gradient, wd, weight))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum·mom − lr·g``, then ``weight += mom``, in place."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
