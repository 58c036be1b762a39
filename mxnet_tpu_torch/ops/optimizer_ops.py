"""Optimizer update ops: counterparts of ``sgd_update``, ``sgd_mom_update``
and ``adam_update`` in ``mxnet_tpu/ops/optimizer_ops.py``.

The JAX ops return new arrays; these update ``weight`` (and the momentum)
in place, which keeps one copy of each in device memory.  The arithmetic
is the same, in the same order: MXNet's rule
``mom = momentum·mom − lr·(rescale·g + wd·w)``, then ``w += mom``, which is
not ``torch.optim.SGD``'s.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad if rescale_grad == 1.0 else grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """``weight -= lr·g`` in place, ``g`` rescaled, clipped (when
    ``clip_gradient`` > 0) and decayed.  An ``lr`` given as a float32
    tensor (a training step's) computes as the JAX compiled step does: for
    a narrower weight, ``g`` in the weight's dtype, ``lr·g`` and the
    difference in fp32, one rounding to the weight's dtype."""
    if _fp32_form(lr, weight):
        g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
        weight.copy_(weight.float() - lr * g.float())
        return
    weight.sub_(lr * _prep(grad, rescale_grad, clip_gradient, wd, weight))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum·mom − lr·g``, then ``weight += mom``, in place.  With
    a float32 tensor ``lr`` and a narrower weight the new momentum is fp32
    (``momentum·mom`` in the weight's dtype, ``lr·g`` in fp32) and both
    the weight and the momentum are rounded to their dtype once, as in the
    JAX compiled step."""
    if _fp32_form(lr, weight):
        g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
        m2 = _weak(momentum, mom.dtype) * mom - lr * g.float()
        weight.copy_(weight.float() + m2)
        mom.copy_(m2)
        return
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)


@functools.lru_cache(maxsize=None)
def _weak(x, dtype):
    """The Python scalar ``x`` rounded to ``dtype``, as jnp takes a
    weak-typed scalar into an array's dtype (0.999 is 0.99609375 in
    bf16)."""
    return None if x is None else float(torch.tensor(x, dtype=dtype))


def _fp32_form(lr, weight) -> bool:
    """A float32 tensor ``lr`` (a training step's) on a weight narrower
    than fp32: the update takes the JAX compiled step's fp32 form.  On an
    fp32 weight that form is the in-place one, value for value."""
    return isinstance(lr, torch.Tensor) and weight.dtype != torch.float32


def _prep_weak(grad, rescale_grad, clip_gradient, wd, weight):
    """:func:`_prep` with each scalar rounded to the weight's dtype."""
    dt = weight.dtype
    return _prep(grad, _weak(rescale_grad, dt), _weak(clip_gradient, dt),
                 _weak(wd, dt), weight)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """``mean = β1·mean + (1 − β1)·g``, ``var = β2·var + (1 − β2)·g²``, then
    ``weight -= lr·mean / (sqrt(var) + ε)``, in place; ``lr`` already
    carries the bias correction (the optimizer's).

    As in the JAX op, every Python scalar enters in the weight's dtype
    and every op rounds to it.  An ``lr`` given as a float32 tensor (the
    JAX compiled step traces it as a float32 array) runs the last line in
    fp32 on the device instead, so a bf16 weight is rounded once and no
    value is read back to the host."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    mean.copy_(_weak(beta1, dt) * mean + _weak(1.0 - beta1, dt) * g)
    var.copy_(_weak(beta2, dt) * var + _weak(1.0 - beta2, dt) * g.square())
    denom = var.sqrt() + _weak(epsilon, dt)
    if isinstance(lr, torch.Tensor):
        weight.copy_(weight.float() - lr * mean.float() / denom.float())
    else:
        weight.sub_(_weak(lr, dt) * mean / denom)
