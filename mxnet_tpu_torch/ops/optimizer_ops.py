"""Optimizer update ops: the counterparts of ``mxnet_tpu/ops/optimizer_ops.py``
and of ``multi_sgd_update`` / ``multi_sgd_mom_update``
(``mxnet_tpu/ops/contrib_ops.py``).

Two forms of each single-tensor update.  The in-place function
(``sgd_update(weight, grad, ...)``, ``ftml_update(...)``, ...) writes the
new weight and states into its arguments, which keeps one copy of each
in device memory; the optimizer classes call it, also inside a training
step's CUDA graph.  The registry op of the same name (``mx.nd.sgd_update``)
is the JAX op: it returns new tensors ``(weight, *states)`` and leaves its
inputs alone, and ``out=`` writes them back.  It runs the in-place
function on copies, so the two forms compute the same values.  The
multi-tensor ops (``multi_*``, ``preloaded_*``, ``_multi_*``) are
registry ops only.

The arithmetic is the JAX op's, in the same order: MXNet's rule
``mom = momentum·mom − lr·(rescale·g + wd·w)``, then ``w += mom``, which is
not ``torch.optim.SGD``'s.  Every Python scalar enters in the dtype of the
array it meets (``_weak``: jnp takes a weak-typed scalar into an array's
dtype, so 0.999 is 0.99609375 in bf16).  An ``lr`` given as a float32
tensor (a training step's) multiplies in fp32 and a narrower weight is
rounded once (``_fp32_form``), as the JAX compiled step computes; other
per-step scalars (the step count ``t`` and what is made from it) may be
0-dim tensors too, and nothing here reads a tensor back to the host.  A
device scalar given as an array (``preloaded_*``'s rates,
``_mp_adamw_update``'s ``rescale_grad``) promotes what it meets as jnp
promotes arrays.
"""
from __future__ import annotations

import functools

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "nag_mom_update", "signsgd_update",
           "signum_update", "adam_update", "adamw_update", "ftml_update",
           "ftrl_update", "rmsprop_update", "rmspropalex_update",
           "lamb_update_phase1", "lamb_update_phase2"]


# ---------------------------------------------------------------- scalars
@functools.lru_cache(maxsize=4096)
def _weak(x, dtype):
    """The Python scalar ``x`` rounded to ``dtype``, as jnp takes a
    weak-typed scalar into an array's dtype (0.999 is 0.99609375 in
    bf16)."""
    if x is None or dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(x, dtype=dtype))


def _s(x, dtype):
    """A scalar beside an array of ``dtype``: a Python number as
    :func:`_weak` rounds it, a tensor as is."""
    return x if isinstance(x, torch.Tensor) else _weak(x, dtype)


def _fp32_form(lr, weight) -> bool:
    """A float32 tensor ``lr`` (a training step's) on a weight narrower
    than fp32: the update takes the JAX compiled step's fp32 form.  On an
    fp32 weight that form is the in-place one, value for value."""
    return isinstance(lr, torch.Tensor) and weight.dtype != torch.float32


def _sub_lr(weight, lr, x):
    """``weight -= lr·x`` in place; in the fp32 form ``lr·x`` and the
    difference in fp32, one rounding to the weight's dtype."""
    if _fp32_form(lr, weight):
        weight.copy_(weight.float() - lr * x.float())
    else:
        weight.sub_(_s(lr, weight.dtype) * x)


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad if rescale_grad == 1.0 else grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight
    return g


def _prep_weak(grad, rescale_grad, clip_gradient, wd, weight):
    """:func:`_prep` with each scalar rounded to the weight's dtype."""
    dt = weight.dtype
    return _prep(grad, _weak(rescale_grad, dt), _weak(clip_gradient, dt),
                 _weak(wd, dt), weight)


def _clipped(g, rescale, clip):
    """``g·rescale``, clipped to ±clip when ``clip`` > 0 (the multi ops'
    form: the product is always taken)."""
    g = g * _s(rescale, g.dtype)
    return g.clamp(-clip, clip) if clip > 0 else g


def _up(*xs):
    """The tensors cast to the dtype jnp promotes them to (a 0-dim fp32
    tensor widens a bf16 array, which torch's promotion does not)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


# ------------------------------------------------ single-tensor, in place
@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None, lazy_update=True):
    """``weight -= lr·g`` in place, ``g`` rescaled, clipped (when
    ``clip_gradient`` > 0) and decayed.  An ``lr`` given as a float32
    tensor (a training step's) computes as the JAX compiled step does: for
    a narrower weight, ``g`` in the weight's dtype, ``lr·g`` and the
    difference in fp32, one rounding to the weight's dtype."""
    _sub_lr(weight, lr, _prep_weak(grad, rescale_grad, clip_gradient, wd,
                                   weight))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None, lazy_update=True):
    """``mom = momentum·mom − lr·g``, then ``weight += mom``, in place.  With
    a float32 tensor ``lr`` and a narrower weight the new momentum is fp32
    (``momentum·mom`` in the weight's dtype, ``lr·g`` in fp32) and both
    the weight and the momentum are rounded to their dtype once, as in the
    JAX compiled step."""
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    if _fp32_form(lr, weight):
        m2 = _weak(momentum, mom.dtype) * mom - lr * g.float()
        weight.copy_(weight.float() + m2)
        mom.copy_(m2)
        return
    mom.mul_(_weak(momentum, mom.dtype)).sub_(_s(lr, weight.dtype) * g)
    weight.add_(mom)


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None, lazy_update=True):
    """:func:`sgd_update` on the fp32 master copy ``weight32`` with the
    gradient in fp32, then ``weight`` = the copy in its own dtype."""
    sgd_update(weight32, grad.float(), lr, wd, rescale_grad, clip_gradient)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=None,
                      lazy_update=True):
    """:func:`sgd_mom_update` on the fp32 master copy with an fp32
    momentum, then ``weight`` = the copy in its own dtype."""
    sgd_mom_update(weight32, grad.float(), mom, lr, momentum, wd,
                   rescale_grad, clip_gradient)
    weight.copy_(weight32)


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """Nesterov: ``mom = momentum·mom + g``, then
    ``weight -= lr·(g + momentum·mom)``, in place."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    m = _weak(momentum, dt)
    mom.mul_(m).add_(g)
    _sub_lr(weight, lr, g + m * mom)


@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """``weight -= lr·(sign(g) + wd·weight)``; ``g`` rescaled and clipped,
    not decayed."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, 0.0, weight)
    _sub_lr(weight, lr, torch.sign(g) + _weak(wd, dt) * weight)


@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=None, wd_lh=0.0):
    """``mom = momentum·mom − (1 − momentum)·g``, then
    ``weight += lr·sign(mom)`` and, with ``wd_lh``,
    ``weight -= lr·wd_lh·weight`` (of the weight before the step)."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(_weak(momentum, dt)).sub_(_weak(1.0 - momentum, dt) * g)
    if _fp32_form(lr, weight):
        w = weight.float() + lr * torch.sign(mom).float()
        if wd_lh:
            w = w - (lr * wd_lh) * weight.float()
    else:
        w = weight + _s(lr, dt) * torch.sign(mom)
        if wd_lh:
            w = w - _s(lr * wd_lh, dt) * weight
    weight.copy_(w)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None,
                lazy_update=True):
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


@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=None):
    """Decoupled decay: Adam's moments of the rescaled, clipped gradient,
    then ``weight -= eta·(lr·mean / (sqrt(var) + ε) + wd·weight)``."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, 0.0, weight)
    mean.copy_(_weak(beta1, dt) * mean + _weak(1.0 - beta1, dt) * g)
    var.copy_(_weak(beta2, dt) * var + _weak(1.0 - beta2, dt) * g.square())
    denom = var.sqrt() + _weak(epsilon, dt)
    if _fp32_form(lr, weight):
        step = lr * mean.float() / denom.float() + _weak(wd, dt) * weight
        weight.copy_(weight.float() - eta * step)
    else:
        step = _s(lr, dt) * mean / denom + _weak(wd, dt) * weight
        weight.sub_(_weak(eta, dt) * step)


@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=None,
                t=1):
    """FTML: ``v = β2·v + (1 − β2)·g²``,
    ``d' = (1 − β1^t)/lr·(sqrt(v/(1 − β2^t)) + ε)``,
    ``z = β1·z + (1 − β1)·g − (d' − β1·d)·weight``, ``d = d'``,
    ``weight = −z/d``, in place."""
    _ftml(weight, grad, d, v, z, ((1.0 - beta1 ** t) / lr, 1.0 - beta2 ** t),
          beta1, beta2, epsilon, wd, rescale_grad, clip_grad)


def _ftml(weight, grad, d, v, z, scalars, beta1, beta2, epsilon, wd,
          rescale_grad, clip_grad):
    """:func:`ftml_update` with its per-step scalars ``((1 − β1^t)/lr,
    1 − β2^t)`` given (a training step makes them once)."""
    dt = weight.dtype
    c_d, c_v = scalars
    g = _prep_weak(grad, rescale_grad, clip_grad, wd, weight)
    v.copy_(_weak(beta2, dt) * v + _weak(1.0 - beta2, dt) * g.square())
    d2 = _s(c_d, dt) * (torch.sqrt(v / _s(c_v, dt)) + _weak(epsilon, dt))
    sigma = d2 - _weak(beta1, dt) * d
    z.copy_(_weak(beta1, dt) * z + _weak(1.0 - beta1, dt) * g
            - sigma * weight)
    d.copy_(d2)
    weight.copy_(-z / d)


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=None):
    """FTRL-proximal: ``n' = n + g²``,
    ``z += g − (sqrt(n') − sqrt(n))/lr·weight``, ``n = n'``, then
    ``weight = (sign(z)·λ1 − z) / ((β + sqrt(n))/lr + wd)`` where
    ``|z| > λ1``, else 0."""
    dt = weight.dtype
    g = grad * _weak(rescale_grad, dt)
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-_weak(clip_gradient, dt), _weak(clip_gradient, dt))
    n2 = n + g.square()
    z.copy_(z + g - (torch.sqrt(n2) - torch.sqrt(n)) / _s(lr, dt) * weight)
    n.copy_(n2)
    lam = _weak(lamda1, dt)
    weight.copy_((torch.sign(z) * lam - z)
                 / ((_weak(beta, dt) + torch.sqrt(n)) / _s(lr, dt)
                    + _weak(wd, dt)) * (z.abs() > lam))


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        c = _weak(clip_weights, w.dtype)
        return w.clamp(-c, c)
    return w


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=None,
                   clip_weights=None):
    """``n = γ1·n + (1 − γ1)·g²``, ``weight -= lr·g / sqrt(n + ε)``, the
    weight clipped to ±``clip_weights`` when that is > 0."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    n.copy_(_weak(gamma1, dt) * n + _weak(1.0 - gamma1, dt) * g.square())
    den = torch.sqrt(n + _weak(epsilon, dt))
    if _fp32_form(lr, weight):
        w = weight.float() - lr * g.float() / den.float()
    else:
        w = weight - _s(lr, dt) * g / den
    weight.copy_(_clip_weights(w, clip_weights))


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=None,
                       clip_weights=None):
    """Centered RMSProp (Graves): ``n = γ1·n + (1 − γ1)·g²``,
    ``g_state = γ1·g_state + (1 − γ1)·g``,
    ``delta = γ2·delta − lr·g / sqrt(n − g_state² + ε)``,
    ``weight += delta``, clipped as :func:`rmsprop_update`."""
    dt = weight.dtype
    g = _prep_weak(grad, rescale_grad, clip_gradient, wd, weight)
    g1, h1 = _weak(gamma1, dt), _weak(1.0 - gamma1, dt)
    n.copy_(g1 * n + h1 * g.square())
    g_state.copy_(g1 * g_state + h1 * g)
    den = torch.sqrt(n - g_state.square() + _weak(epsilon, dt))
    if _fp32_form(lr, weight):
        d2 = _weak(gamma2, dt) * delta - lr * g.float() / den.float()
        w = weight.float() + d2
    else:
        d2 = _weak(gamma2, dt) * delta - _s(lr, dt) * g / den
        w = weight + d2
    delta.copy_(d2)
    weight.copy_(_clip_weights(w, clip_weights))


def _bias_corrected(mean, var, corr):
    """``mean/(1 − β1^t)``, ``var/(1 − β2^t)`` for ``corr`` the two
    denominators; None: no correction."""
    if corr is None:
        return mean, var
    dt = mean.dtype
    return mean / _s(corr[0], dt), var / _s(corr[1], dt)


def _lamb_corr(beta1, beta2, t, bias_correction):
    return (1.0 - beta1 ** t, 1.0 - beta2 ** t) if bias_correction else None


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=None):
    """LAMB's first phase: the moments (``mean`` and ``var`` updated in
    place) and the returned direction
    ``mhat / (sqrt(vhat) + ε) + wd·weight``, with the bias correction by
    step ``t`` when ``bias_correction``."""
    return _lamb_phase1(weight, grad, mean, var, beta1, beta2, epsilon,
                        _lamb_corr(beta1, beta2, t, bias_correction), wd,
                        rescale_grad, clip_gradient)


def _lamb_phase1(weight, grad, mean, var, beta1, beta2, epsilon, corr, wd,
                 rescale_grad, clip_gradient):
    """:func:`lamb_update_phase1` with the bias correction's denominators
    given (a training step makes them once)."""
    dt = weight.dtype
    g = grad * _weak(rescale_grad, dt)
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-_weak(clip_gradient, dt), _weak(clip_gradient, dt))
    mean.copy_(_weak(beta1, dt) * mean + _weak(1.0 - beta1, dt) * g)
    var.copy_(_weak(beta2, dt) * var + _weak(1.0 - beta2, dt) * g.square())
    mhat, vhat = _bias_corrected(mean, var, corr)
    return mhat / (torch.sqrt(vhat) + _weak(epsilon, dt)) \
        + _weak(wd, dt) * weight


def _trust(r1, r2, lower_bound, upper_bound):
    """``r1/r2`` where both are > 0, else 1, ``r1`` first held to
    [lower_bound, upper_bound] (a bound ≤ 0 is none); on the device."""
    if lower_bound is not None and lower_bound > 0:
        r1 = r1.clamp(min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = r1.clamp(max=upper_bound)
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)


@torch.no_grad()
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=None,
                       upper_bound=None):
    """``weight -= lr·ratio·g_update`` in place, ``ratio`` =
    :func:`_trust` of the norms ``r1`` (weight) and ``r2`` (direction)."""
    ratio = _trust(r1.reshape(()), r2.reshape(()), lower_bound, upper_bound)
    if _fp32_form(lr, weight):
        weight.copy_(weight.float() - lr * ratio * g_update.float())
    else:
        weight.sub_(_s(lr, weight.dtype) * ratio * g_update)


# ------------------------------------------------------------ registry ops
def _functional(name, inplace, nin, aliases=()):
    """Register ``name`` as the JAX op over ``inplace``: it copies the
    weight and the states (every input but the gradient, input 1), runs
    ``inplace`` on the copies and returns them."""

    def op(*args, **params):
        outs = [a.clone() for i, a in enumerate(args) if i != 1]
        inplace(*outs[:1], args[1], *outs[1:], **params)
        return outs[0] if len(outs) == 1 else tuple(outs)
    op.__name__ = name
    op.__doc__ = inplace.__doc__
    register(name, nin=nin, differentiable=False, aliases=aliases)(op)


for _name, _fn, _nin in (
        ("sgd_update", sgd_update, 2), ("sgd_mom_update", sgd_mom_update, 3),
        ("mp_sgd_update", mp_sgd_update, 3),
        ("mp_sgd_mom_update", mp_sgd_mom_update, 4),
        ("nag_mom_update", nag_mom_update, 3),
        ("signsgd_update", signsgd_update, 2),
        ("signum_update", signum_update, 3),
        ("adam_update", adam_update, 4), ("ftml_update", ftml_update, 5),
        ("ftrl_update", ftrl_update, 4),
        ("rmsprop_update", rmsprop_update, 3),
        ("rmspropalex_update", rmspropalex_update, 5)):
    _functional(_name, _fn, _nin)
_functional("adamw_update", adamw_update, 4,
            aliases=["_contrib_adamw_update", "_adamw_update"])
del _name, _fn, _nin


@register("lamb_update_phase1", nin=4, nout=3, differentiable=False)
def _lamb_phase1_op(weight, grad, mean, var, **params):
    mean, var = mean.clone(), var.clone()
    return lamb_update_phase1(weight, grad, mean, var, **params), mean, var


@register("lamb_update_phase2", nin=4, differentiable=False)
def _lamb_phase2_op(weight, g_update, r1, r2, **params):
    w = weight.clone()
    lamb_update_phase2(w, g_update, r1, r2, **params)
    return w


@register("mp_nag_mom_update", nin=4, nout=3, differentiable=False)
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum on the fp32 master weights."""
    g = _clipped(grad.float(), rescale_grad, clip_gradient)
    g = g + wd * weight32
    m_new = momentum * mom + g
    new32 = weight32 - lr * (g + momentum * m_new)
    return new32.to(weight.dtype), m_new, new32


def _lamb_math(weight32, grad, mean, var, beta1, beta2, epsilon, t,
               bias_correction, wd, rescale_grad, clip_gradient):
    """LAMB's first phase over an fp32 gradient: ``(mean, var, direction)``
    as new tensors."""
    g = _clipped(grad.float(), rescale_grad, clip_gradient)
    m = _s(beta1, mean.dtype) * mean + (1 - beta1) * g
    v = _s(beta2, var.dtype) * var + (1 - beta2) * g * g
    mh, vh = _bias_corrected(m, v, _lamb_corr(beta1, beta2, t,
                                              bias_correction))
    return m, v, mh / (torch.sqrt(vh) + epsilon) \
        + _s(wd, weight32.dtype) * weight32


@register("mp_lamb_update_phase1", nin=5, nout=3, differentiable=False)
def _mp_lamb_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                    beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    m, v, upd = _lamb_math(weight32, grad, mean, var, beta1, beta2, epsilon,
                           t, bias_correction, wd, rescale_grad,
                           clip_gradient)
    return upd, m, v


@register("mp_lamb_update_phase2", nin=5, nout=2, differentiable=False)
def _mp_lamb_phase2(weight, g_update, r1, r2, weight32, lr=0.01,
                    lower_bound=-1.0, upper_bound=-1.0):
    new32 = weight32 - lr * _trust(r1, r2, lower_bound, upper_bound) \
        * g_update
    return new32.to(weight.dtype), new32


@register("all_finite", nin=1, differentiable=False,
          aliases=["_contrib_all_finite"])
def _all_finite(data, init_output=True):
    """1.0 when every element is finite, else 0.0, as a [1] float32 tensor.
    As in the JAX op, ``init_output=False`` does not AND into an earlier
    result: a caller that accumulates ANDs the flags itself."""
    return torch.isfinite(data).all().reshape(1).float()


@register("multi_all_finite", nin=None, differentiable=False,
          aliases=["_contrib_multi_all_finite"])
def _multi_all_finite(args, num_arrays=1, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=args[0].device)
    for a in args:
        ok = ok & torch.isfinite(a).all()
    return ok.reshape(1).float()


def _groups(args, per):
    return [args[i:i + per] for i in range(0, len(args) - per + 1, per)]


@register("multi_sum_sq", nin=None, differentiable=False,
          aliases=["_contrib_multi_sum_sq"])
def _multi_sum_sq(args, num_arrays=1, scale=1.0):
    """Each tensor's sum of squares in fp32, times ``scale``: [N]."""
    return torch.stack([(a.float() ** 2).sum() * scale for a in args])


@register("reset_arrays", nin=None, differentiable=False,
          aliases=["_contrib_reset_arrays"])
def _reset_arrays(args, num_arrays=1):
    """Zeros shaped like each input (``out=`` writes them back)."""
    return tuple(torch.zeros_like(a) for a in args)


@register("multi_lars", nin=4, differentiable=False,
          aliases=["_contrib_multi_lars"])
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
                rescale_grad=1.0):
    """Layer-wise LARS rates: ``lr·eta·|w| / (|g|·rescale + wd·|w| + eps)``
    where both norms are > 0, else ``lr``."""
    w_norm = torch.sqrt(weights_sum_sq)
    valid = (w_norm > 0) & (grads_sum_sq > 0)
    lars = lrs * eta * w_norm / (torch.sqrt(grads_sum_sq) * rescale_grad
                                 + wds * w_norm + eps)
    return torch.where(valid, lars, lrs)


@register("multi_sgd_update", nin=None, differentiable=False)
def _multi_sgd_update(args, lrs=(), wds=(), rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=0):
    """``[(w, g)] × k`` → the k updated weights."""
    outs = []
    for (w, g), lr, wd in zip(_groups(args, 2), lrs, wds):
        dt = w.dtype
        g = _clipped(g, rescale_grad, clip_gradient)
        outs.append(w - _s(lr, dt) * (g + _s(wd, dt) * w))
    return tuple(outs)


@register("multi_sgd_mom_update", nin=None, differentiable=False)
def _multi_sgd_mom_update(args, lrs=(), wds=(), momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=0):
    """``[(w, g, mom)] × k`` → k × (weight, mom)."""
    outs = []
    for (w, g, m), lr, wd in zip(_groups(args, 3), lrs, wds):
        dt = w.dtype
        g = _clipped(g, rescale_grad, clip_gradient)
        m_new = _s(momentum, dt) * m - _s(lr, dt) * (g + _s(wd, dt) * w)
        outs += [w + m_new, m_new]
    return tuple(outs)


@register("multi_mp_sgd_update", nin=None, differentiable=False)
def _multi_mp_sgd_update(args, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=0):
    """``[(w, g, w32)] × k``: each fp32 master updated; k × (w, w32)."""
    outs = []
    for (w, g, w32), lr, wd in zip(_groups(args, 3), lrs, wds):
        g32 = _clipped(g.float(), rescale_grad, clip_gradient)
        new32 = w32 - lr * (g32 + wd * w32)
        outs += [new32.to(w.dtype), new32]
    return tuple(outs)


@register("multi_mp_sgd_mom_update", nin=None, differentiable=False)
def _multi_mp_sgd_mom_update(args, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=0):
    """``[(w, g, mom, w32)] × k`` → k × (w, mom, w32)."""
    outs = []
    for (w, g, m, w32), lr, wd in zip(_groups(args, 4), lrs, wds):
        g32 = _clipped(g.float(), rescale_grad, clip_gradient)
        m_new = momentum * m - lr * (g32 + wd * w32)
        new32 = w32 + m_new
        outs += [new32.to(w.dtype), m_new, new32]
    return tuple(outs)


def _preloaded(args, per):
    """The groups, then the rates and decays: the last two inputs, device
    tensors, so rates made on the device (``multi_lars``) stay there."""
    return _groups(args[:-2], per), args[-2], args[-1]


@register("preloaded_multi_sgd_update", nin=None, differentiable=False)
def _preloaded_multi_sgd_update(args, rescale_grad=1.0, clip_gradient=-1.0,
                                num_weights=0):
    groups, lrs, wds = _preloaded(args, 2)
    outs = []
    for i, (w, g) in enumerate(groups):
        gg = _clipped(g, rescale_grad, clip_gradient)
        w_, gg, lr, wd = _up(w, gg, lrs[i], wds[i])
        outs.append(w_ - lr * (gg + wd * w_))
    return tuple(outs)


@register("preloaded_multi_sgd_mom_update", nin=None, differentiable=False)
def _preloaded_multi_sgd_mom_update(args, momentum=0.0, rescale_grad=1.0,
                                    clip_gradient=-1.0, num_weights=0):
    groups, lrs, wds = _preloaded(args, 3)
    outs = []
    for i, (w, g, m) in enumerate(groups):
        gg = _clipped(g, rescale_grad, clip_gradient)
        mm = _s(momentum, m.dtype) * m
        w_, gg, mm, lr, wd = _up(w, gg, mm, lrs[i], wds[i])
        m_new = mm - lr * (gg + wd * w_)
        outs += [w_ + m_new, m_new]
    return tuple(outs)


@register("preloaded_multi_mp_sgd_update", nin=None, differentiable=False)
def _preloaded_multi_mp_sgd_update(args, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=0):
    groups, lrs, wds = _preloaded(args, 3)
    outs = []
    for i, (w, g, w32) in enumerate(groups):
        g32 = _clipped(g.float(), rescale_grad, clip_gradient)
        new32 = w32 - lrs[i] * (g32 + wds[i] * w32)
        outs += [new32.to(w.dtype), new32]
    return tuple(outs)


@register("preloaded_multi_mp_sgd_mom_update", nin=None,
          differentiable=False)
def _preloaded_multi_mp_sgd_mom_update(args, momentum=0.0, rescale_grad=1.0,
                                       clip_gradient=-1.0, num_weights=0):
    groups, lrs, wds = _preloaded(args, 4)
    outs = []
    for i, (w, g, m, w32) in enumerate(groups):
        g32 = _clipped(g.float(), rescale_grad, clip_gradient)
        m_new = momentum * m - lrs[i] * (g32 + wds[i] * w32)
        new32 = w32 + m_new
        outs += [new32.to(w.dtype), m_new, new32]
    return tuple(outs)


def _full_lamb(w32, g, m, v, lr, wd, beta1, beta2, epsilon, t,
               bias_correction, rescale_grad, clip_gradient, lower_bound,
               upper_bound):
    """Both LAMB phases on one tensor: ``(mean, var, new weight)``."""
    m2, v2, upd = _lamb_math(w32, g, m, v, beta1, beta2, epsilon, t,
                             bias_correction, wd, rescale_grad,
                             clip_gradient)
    ratio = _trust(torch.linalg.vector_norm(w32),
                   torch.linalg.vector_norm(upd), lower_bound, upper_bound)
    return m2, v2, w32 - lr * ratio * upd


@register("_multi_lamb_update", nin=None, differentiable=False,
          aliases=["multi_lamb_update"])
def _multi_lamb_update(args, learning_rates=(), wds=(), beta1=0.9,
                       beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                       lower_bound=-1.0, upper_bound=-1.0,
                       clip_gradient=-1.0, bias_correction=True,
                       step_count=(), num_tensors=0):
    """Whole LAMB over ``[(w, g, mean, var)] × k`` → k × (w, mean, var)."""
    outs = []
    for (w, g, m, v), lr, wd, t in zip(_groups(args, 4), learning_rates, wds,
                                       step_count):
        m2, v2, new_w = _full_lamb(w, g, m, v, lr, wd, beta1, beta2, epsilon,
                                   t, bias_correction, rescale_grad,
                                   clip_gradient, lower_bound, upper_bound)
        outs += [new_w, m2, v2]
    return tuple(outs)


@register("_multi_mp_lamb_update", nin=None, differentiable=False,
          aliases=["multi_mp_lamb_update"])
def _multi_mp_lamb_update(args, learning_rates=(), wds=(), beta1=0.9,
                          beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                          lower_bound=-1.0, upper_bound=-1.0,
                          clip_gradient=-1.0, bias_correction=True,
                          step_count=(), num_tensors=0):
    """``[(w, g, mean, var, w32)] × k`` → k × (w, mean, var, w32)."""
    outs = []
    for (w, g, m, v, w32), lr, wd, t in zip(_groups(args, 5), learning_rates,
                                            wds, step_count):
        m2, v2, new32 = _full_lamb(w32, g, m, v, lr, wd, beta1, beta2,
                                   epsilon, t, bias_correction, rescale_grad,
                                   clip_gradient, lower_bound, upper_bound)
        outs += [new32.to(w.dtype), m2, v2, new32]
    return tuple(outs)


def _adamw_math(w32, g, m, v, lr, eta, wd, beta1, beta2, epsilon, rescale,
                clip_gradient=-1.0):
    g32 = g.float() * rescale
    if clip_gradient > 0:
        g32 = g32.clamp(-clip_gradient, clip_gradient)
    m2 = _s(beta1, m.dtype) * m + (1 - beta1) * g32
    v2 = _s(beta2, v.dtype) * v + (1 - beta2) * g32 * g32
    new32 = w32 - eta * (lr * m2 / (torch.sqrt(v2) + epsilon)
                         + _s(wd, w32.dtype) * w32)
    return m2, v2, new32


@register("_mp_adamw_update", nin=6, nout=4, differentiable=False,
          aliases=["mp_adamw_update"])
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                     lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, clip_gradient=-1.0):
    """AdamW on the fp32 master weights; ``rescale_grad`` is a device
    scalar (a dynamic loss scale is never read back)."""
    m2, v2, new32 = _adamw_math(weight32, grad, mean, var, lr, eta, wd,
                                beta1, beta2, epsilon,
                                rescale_grad.reshape(()), clip_gradient)
    return new32.to(weight.dtype), m2, v2, new32


@register("_multi_adamw_update", nin=None, differentiable=False,
          aliases=["multi_adamw_update"])
def _multi_adamw_update(args, lrs=(), wds=(), etas=(), beta1=0.9,
                        beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                        num_weights=0):
    """AdamW over ``[(w, g, mean, var)] × k``; the last input is the
    shared device rescale scalar."""
    rescale = args[-1].reshape(())
    outs = []
    for (w, g, m, v), lr, wd, eta in zip(_groups(args[:-1], 4), lrs, wds,
                                         etas):
        m2, v2, new_w = _adamw_math(w, g, m, v, lr, eta, wd, beta1, beta2,
                                    epsilon, rescale, clip_gradient)
        outs += [new_w.to(w.dtype), m2, v2]
    return tuple(outs)


@register("_multi_mp_adamw_update", nin=None, differentiable=False,
          aliases=["multi_mp_adamw_update"])
def _multi_mp_adamw_update(args, lrs=(), wds=(), etas=(), beta1=0.9,
                           beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                           num_weights=0):
    rescale = args[-1].reshape(())
    outs = []
    for (w, g, m, v, w32), lr, wd, eta in zip(_groups(args[:-1], 5), lrs,
                                              wds, etas):
        m2, v2, new32 = _adamw_math(w32, g, m, v, lr, eta, wd, beta1, beta2,
                                    epsilon, rescale, clip_gradient)
        outs += [new32.to(w.dtype), m2, v2, new32]
    return tuple(outs)


@register("_contrib_group_adagrad_update", nin=3, nout=2,
          differentiable=False, aliases=["group_adagrad_update"])
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """Row-wise AdaGrad: ``history[r]`` accumulates the row's mean g²; the
    row shares one scale."""
    dt = weight.dtype
    g = _clipped(grad, rescale_grad, clip_gradient)
    row_ssq = (g.reshape(g.shape[0], -1) ** 2).mean(dim=1)
    h_new = history + row_ssq.reshape(history.shape)
    denom = torch.sqrt(h_new + _s(epsilon, h_new.dtype)).reshape(
        (-1,) + (1,) * (g.ndim - 1))
    return weight - _s(lr, dt) * g / denom, h_new


@register("_sparse_adagrad_update", nin=3, nout=2, differentiable=False,
          aliases=["adagrad_update"])
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """Element-wise AdaGrad on dense input (a row-sparse gradient is
    ROADMAP A15)."""
    dt = weight.dtype
    g = _clipped(grad, rescale_grad, clip_gradient)
    h_new = history + g * g
    return weight - _s(lr, dt) * (g / (torch.sqrt(h_new) + _s(epsilon, dt))
                                  + _s(wd, dt) * weight), h_new
