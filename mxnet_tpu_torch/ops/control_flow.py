"""Control-flow ops: ``_foreach``, ``_while_loop``, ``_cond``.

Counterpart of ``mxnet_tpu/ops/control_flow.py`` (reference
``src/operator/control_flow.cc``), which lowers them onto ``lax.scan``,
a masked ``scan`` and ``lax.cond``.  Here they keep the same static
forms: ``_foreach`` loops over the data's leading axis, ``_while_loop``
runs all ``max_iterations`` steps with an active mask (``torch.where``,
never a host read of the condition) and ``_cond`` computes both branches
and selects one with ``torch.where``.  Shapes never depend on values, so
a hybridized block that calls them can be captured in a CUDA graph.

The user's callables take and return NDArrays over the op's tensors.
They record on the tape exactly when the op itself does (its invoke ran
with torch's grad mode on), so the op's outputs are differentiable
through them; an array the callables close over is recorded too.
"""
from __future__ import annotations

import torch

from .. import autograd
from .registry import register

__all__ = []


def _arrays(tensors):
    from ..ndarray.ndarray import NDArray
    return [NDArray(t) for t in tensors]


def _tensors(x):
    out = x if isinstance(x, (list, tuple)) else [x]
    return [o._data if hasattr(o, "_data") else o for o in out]


def _call(fn, *args):
    """``fn(*args)`` recording when the op records."""
    with autograd._RecordingState(torch.is_grad_enabled(), None):
        return fn(*args)


def _flag(x) -> torch.Tensor:
    """A condition's value as a 0-d bool tensor (on its device)."""
    return _tensors(x)[0].reshape(()).to(torch.bool)


@register("_foreach", nin=None)
def _foreach(arrays, body=None, n_states: int = 0, n_outputs: int = 1,
             n_data: int = 1):
    """``body(x_t, states) -> (outputs, new_states)`` over axis 0 of the
    data array(s).  ``arrays`` = [data_1..data_n, *init_states]; returns
    (out_1..out_k, *final_states), each output stacked over the steps."""
    data, states = list(arrays[:n_data]), list(arrays[n_data:])
    steps = []
    for t in range(data[0].shape[0]):
        xs = _arrays([d[t] for d in data])
        out, new = _call(body, xs[0] if n_data == 1 else xs, _arrays(states))
        steps.append(_tensors(out))
        states = _tensors(new)
    stacked = [torch.stack([s[i] for s in steps]) for i in range(len(steps[0]))]
    return tuple(stacked) + tuple(states)


@register("_while_loop", nin=None)
def _while_loop(arrays, cond=None, func=None, max_iterations: int = 0,
                n_outputs: int = 1):
    """A bounded while loop as ``max_iterations`` masked steps: the loop
    variables stop changing once ``cond`` is false, and the outputs of
    those steps are zeros.  Returns (outputs stacked and padded to
    ``max_iterations``, *final loop variables, the number of steps that
    ran as an int32 scalar)."""
    loop_vars = list(arrays)
    active = _flag(_call(cond, *_arrays(loop_vars)))
    steps, mask = [], []
    for _ in range(int(max_iterations)):
        out, new = _call(func, *_arrays(loop_vars))
        nxt = [torch.where(active, n, v) for n, v in zip(_tensors(new),
                                                         loop_vars)]
        steps.append([torch.where(active, o, torch.zeros_like(o))
                      for o in _tensors(out)])
        mask.append(active)
        active = active & _flag(_call(cond, *_arrays(nxt)))
        loop_vars = nxt
    if steps:
        stacked = [torch.stack([s[i] for s in steps])
                   for i in range(len(steps[0]))]
        count = torch.stack(mask).sum().to(torch.int32)
    else:
        # no step: the outputs' shapes from one call, kept off the tape
        with torch.no_grad():
            probe = _tensors(_call(func, *_arrays(loop_vars))[0])
        stacked = [o.new_zeros((0,) + tuple(o.shape)) for o in probe]
        count = torch.zeros((), dtype=torch.int32, device=active.device)
    return tuple(stacked) + tuple(loop_vars) + (count,)


@register("_cond", nin=None)
def _cond(arrays, pred=None, then_func=None, else_func=None,
          n_outputs: int = 1):
    """``then_func(*arrays)`` where ``pred(*arrays)`` holds, else
    ``else_func(*arrays)``; both branches run, and their outputs must
    match in shape."""
    ins = list(arrays)
    p = _flag(_call(pred, *_arrays(ins)))
    then = _tensors(_call(then_func, *_arrays(ins)))
    other = _tensors(_call(else_func, *_arrays(ins)))
    out = tuple(torch.where(p, a, b) for a, b in zip(then, other))
    return out if len(out) > 1 else out[0]
