"""``mx.nd.contrib``: control flow and the contrib ops.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (reference
``python/mxnet/ndarray/contrib.py``).  ``foreach``, ``while_loop`` and
``cond`` run the fused ops of ``ops/control_flow.py``; under
``autograd.record()`` ``foreach`` and ``while_loop`` unroll in Python
instead, as the reference's imperative path does, so that arrays their
callables close over receive gradients (the unrolled ``while_loop`` reads
its condition on the host each step).  Every ``_contrib_<x>`` op of the
registry is ``<x>`` here, also one registered after import.
"""
from __future__ import annotations

import math
import sys
from typing import Callable

import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..ops import registry as _registry
from .ndarray import NDArray, invoke as _invoke

__all__ = ["foreach", "while_loop", "cond", "boolean_mask", "getnnz",
           "quadratic", "rand_zipfian"]


def _aslist(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(rows):
    return _invoke("stack", [list(rows)], {"axis": 0})


def foreach(body: Callable, data, init_states):
    """``body(data_t, states) -> (out, new_states)`` over axis 0 of
    ``data``, one NDArray or a list scanned in lockstep (``body`` then
    takes a list of slices).  Returns (the outputs stacked over the
    steps, the final states)."""
    states = _aslist(init_states)
    single_data = isinstance(data, NDArray)
    datas = [data] if single_data else list(data)
    if _ag.is_recording():
        outs_t = []
        for t in range(datas[0].shape[0]):
            x_t = datas[0][t] if single_data else [d[t] for d in datas]
            out, states = body(x_t, list(states))
            states = _aslist(states)
            outs_t.append(_aslist(out))
        n_out = len(outs_t[0])
        outs = [_stack([o[i] for o in outs_t]) for i in range(n_out)]
        return (outs[0] if n_out == 1 else outs), _aslist(states)
    # the outputs' count from one step on slice 0
    probe_x = datas[0][0] if single_data else [d[0] for d in datas]
    n_out = len(_aslist(body(probe_x, list(states))[0]))

    def body_multi(x, sts):
        out, new_sts = body(x, sts)
        return _aslist(out), _aslist(new_sts)

    res = _aslist(_invoke("_foreach", [datas + states],
                          {"body": body_multi, "n_states": len(states),
                           "n_outputs": n_out, "n_data": len(datas)}))
    outs = res[:n_out]
    return (outs[0] if n_out == 1 else outs), list(res[n_out:])


def _truth(x) -> bool:
    """A condition's value read on the host; it must be a scalar."""
    if isinstance(x, NDArray):
        if x.size != 1:
            raise TypeError(f"loop/cond condition must be a scalar, got "
                            f"shape {x.shape}")
        return bool(x._data.reshape(-1)[0].item())
    return bool(x)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """A bounded while loop: ``func(*vars) -> (out, new_vars)`` while
    ``cond_fn(*vars)``, at most ``max_iterations`` times.  Returns (the
    outputs stacked and padded with zeros to ``max_iterations``, the
    final loop variables)."""
    loop_vars = _aslist(loop_vars)
    max_iterations = int(max_iterations)
    if _ag.is_recording():
        vars_, outs_steps = list(loop_vars), []
        while len(outs_steps) < max_iterations and _truth(cond_fn(*vars_)):
            out, vars_ = func(*vars_)
            vars_ = _aslist(vars_)
            outs_steps.append(_aslist(out))
        steps_real = len(outs_steps)
        if not outs_steps:
            with _ag.pause():  # the outputs' count and shapes only
                probe_out, _ = func(*loop_vars)
            outs_steps = [[o * 0 for o in _aslist(probe_out)]]
        n_out = len(outs_steps[0])
        zrow = [o * 0 for o in outs_steps[-1]]
        rows = outs_steps[:steps_real] + [zrow] * max(
            0, max_iterations - steps_real)
        if not rows:  # max_iterations == 0: (0, ...)-shaped outputs
            outs = [outs_steps[0][i].expand_dims(0)[0:0]
                    for i in range(n_out)]
        else:
            outs = [_stack([r[i] for r in rows]) for i in range(n_out)]
        return (outs[0] if n_out == 1 else outs), list(vars_)
    n_out = len(_aslist(func(*loop_vars)[0]))

    def func_multi(*vars_):
        out, new_vars = func(*vars_)
        return _aslist(out), _aslist(new_vars)

    res = _aslist(_invoke("_while_loop", [list(loop_vars)],
                          {"cond": cond_fn, "func": func_multi,
                           "max_iterations": max_iterations,
                           "n_outputs": n_out}))
    outs = res[:n_out]
    return (outs[0] if n_out == 1 else outs), list(res[n_out:-1])


def cond(pred: Callable, then_func: Callable, else_func: Callable,
         inputs=None):
    """The reference's form takes callables without arguments that close
    over the arrays: the predicate is read on the host and the chosen
    branch runs (and records).  Given ``inputs``, the three callables take
    them and the fused ``_cond`` op runs, with no host read."""
    if inputs is None or not _aslist(inputs):
        return (then_func if _truth(pred()) else else_func)()
    return _invoke("_cond", [_aslist(inputs)],
                   {"pred": pred, "then_func": then_func,
                    "else_func": else_func})


def boolean_mask(data: NDArray, index: NDArray, axis: int = 0) -> NDArray:
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (eager only: the output's shape depends on the mask)."""
    return _invoke("boolean_mask", [data, index], {"axis": axis})


def getnnz(data, axis=None):
    """The count of nonzero entries (dense arrays; int32)."""
    t = data._data != 0
    n = t.sum() if axis is None else t.sum(int(axis))
    return NDArray(n.to(torch.int32), data.context)


def quadratic(data: NDArray, a=1.0, b=1.0, c=1.0) -> NDArray:
    """a·x² + b·x + c."""
    return data * data * a + data * b + c


def rand_zipfian(true_classes, num_sampled, range_max):
    """A log-uniform candidate sampler: ``num_sampled`` classes with
    P(k) = (log(k+2) - log(k+1)) / log(range_max+1), drawn from
    ``mx.random``'s stream for ``true_classes``' device.  Returns
    (sampled classes (int32), expected count of each true class,
    expected count of each sampled class)."""
    from .. import random as _random
    from ..context import current_context
    if isinstance(true_classes, NDArray):
        ctx, true_raw = true_classes.context, true_classes._data
    else:
        ctx = current_context()
        true_raw = torch.as_tensor(true_classes, device=ctx.torch_device())
    dev = true_raw.device
    log_range = math.log(range_max + 1.0)
    f = torch.rand(int(num_sampled), device=dev,
                   generator=_random.device_generator(dev)) * log_range
    sampled = (torch.exp(f).to(torch.int32) - 1) % int(range_max)

    def expected(classes):
        c = classes.float()
        return (torch.log(c + 2.0) - torch.log(c + 1.0)) / log_range \
            * num_sampled

    return (NDArray(sampled, ctx), NDArray(expected(true_raw), ctx),
            NDArray(expected(sampled), ctx))


def _plain_op_alias(opname):
    """``mx.nd.contrib.<opname>``: the registry op of that name (the
    reference defines these in Python in ``ndarray/contrib.py``)."""
    def fn(*args, **kwargs):
        op = _registry.get(opname)
        return _invoke(op, [list(args)] if op.nin is None else list(args),
                       kwargs)
    fn.__name__ = opname
    fn.__doc__ = f"contrib alias of the {opname!r} op."
    return fn


isinf = _plain_op_alias("isinf")
isfinite = _plain_op_alias("isfinite")
isnan = _plain_op_alias("isnan")
mp_adamw_update = _plain_op_alias("mp_adamw_update")
multi_adamw_update = _plain_op_alias("multi_adamw_update")
multi_lamb_update = _plain_op_alias("multi_lamb_update")
multi_mp_adamw_update = _plain_op_alias("multi_mp_adamw_update")


def multi_mp_lamb_update(*args, step_count=None, learning_rates=(), wds=(),
                         **kwargs):
    """Multi-tensor mixed-precision LAMB: each group of 5 arrays (w, g,
    m, v, w32) runs the registered mp phase 1 and phase 2 ops with the
    trust ratio's norms between them.  ``step_count`` is one t per group
    (a list or an NDArray), or one for all.  Returns [w, m, v, w32] per
    group."""
    p1_keys = ("beta1", "beta2", "epsilon", "rescale_grad", "clip_gradient",
               "bias_correction")
    p1_kw = {k: v for k, v in kwargs.items() if k in p1_keys}
    p2_kw = {k: v for k, v in kwargs.items()
             if k in ("lower_bound", "upper_bound")}
    flat = list(args)
    groups = [flat[i:i + 5] for i in range(0, len(flat) - len(flat) % 5, 5)]
    if step_count is None:
        ts = [1] * len(groups)
    elif isinstance(step_count, (list, tuple)):
        ts = [int(t) for t in step_count]
    elif isinstance(step_count, NDArray):
        sc = step_count.asnumpy().reshape(-1)
        ts = [int(t) for t in sc] if sc.size > 1 else [int(sc[0])] * len(
            groups)
    else:
        ts = [int(step_count)] * len(groups)
    if len(ts) < len(groups):
        ts = ts + [ts[-1] if ts else 1] * (len(groups) - len(ts))
    outs = []
    for (w, g, m, v, w32), lr, wd, t in zip(groups, learning_rates, wds, ts):
        upd, m2, v2 = _invoke("mp_lamb_update_phase1", [w, g, m, v, w32],
                              dict(p1_kw, t=int(t) or 1, wd=wd))
        r1 = _invoke("norm", [w32], {})
        r2 = _invoke("norm", [upd], {})
        new_w, new32 = _invoke("mp_lamb_update_phase2",
                               [w, upd, r1, r2, w32], dict(p2_kw, lr=lr))
        outs.extend([new_w, m2, v2, new32])
    return outs


def _needs_sparse(name):
    def fn(*args, **kwargs):
        raise MXNetError(f"mx.nd.contrib.{name} takes CSRNDArray graphs; "
                         "the sparse arrays are not ported yet (ROADMAP A15)")
    fn.__name__ = name
    return fn


# the DGL graph-sampling family (mxnet_tpu/ndarray/dgl.py)
dgl_adjacency = _needs_sparse("dgl_adjacency")
dgl_csr_neighbor_non_uniform_sample = _needs_sparse(
    "dgl_csr_neighbor_non_uniform_sample")
dgl_csr_neighbor_uniform_sample = _needs_sparse(
    "dgl_csr_neighbor_uniform_sample")
dgl_graph_compact = _needs_sparse("dgl_graph_compact")
dgl_subgraph = _needs_sparse("dgl_subgraph")
edge_id = _needs_sparse("edge_id")


def _codegen_contrib_namespace():
    _registry.expose_contrib_namespace(sys.modules[__name__],
                                       sys.modules[__package__])


def __getattr__(name: str):
    """An op registered after import."""
    from . import _make_op_func
    return _registry.resolve_contrib_late(sys.modules[__name__], name,
                                          _make_op_func)
