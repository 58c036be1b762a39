"""Imperative autograd on torch autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (reference ``python/mxnet/autograd.py``).
The tape is torch's: an op applied under :func:`record` to an array that is
on the tape runs with torch's grad mode on and so leaves a ``grad_fn``; an
op outside ``record()`` (or under :func:`pause`) runs with grad mode off and
builds no graph.  :func:`mark_variables` makes an array's tensor a leaf that
requires grad and tags it with the array, so :func:`backward` can find the
variables a head depends on by walking the ``grad_fn`` graph.

What torch does differently is bridged here: torch *accumulates* into a
leaf's ``.grad``, while MXNet's default ``grad_req="write"`` overwrites, so
gradients are taken with ``torch.autograd.grad`` and written (or, for
``"add"``, added) into each variable's own gradient array.  A second
backward through a freed graph raises :class:`MXNetError`, as the JAX
package's tape does.  :class:`Function` is one ``torch.autograd.Function``
node whose backward calls the user's ``backward`` on NDArrays.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function",
]

_tls = threading.local()


def _state():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
    return _tls


def is_recording() -> bool:
    return _state().recording


def is_training() -> bool:
    return _state().training


def set_recording(flag: bool) -> bool:
    s = _state()
    prev, s.recording = s.recording, flag
    return prev


def set_training(flag: bool) -> bool:
    s = _state()
    prev, s.training = s.training, flag
    return prev


class _RecordingState:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._r, self._t = recording, training

    def __enter__(self):
        s = _state()
        self._pr, self._pt = s.recording, s.training
        if self._r is not None:
            s.recording = self._r
        if self._t is not None:
            s.training = self._t
        return self

    def __exit__(self, *exc):
        s = _state()
        s.recording, s.training = self._pr, self._pt


def record(train_mode: bool = True) -> _RecordingState:
    return _RecordingState(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingState:
    return _RecordingState(False, train_mode)


def train_mode() -> _RecordingState:
    return _RecordingState(None, True)


def predict_mode() -> _RecordingState:
    return _RecordingState(None, False)


# ---------------------------------------------------------------------------
# variables
# ---------------------------------------------------------------------------
def on_tape(arr) -> bool:
    """True if ``arr`` takes part in the tape (a variable or an output of a
    recorded op)."""
    return arr._data.requires_grad


def _is_variable(arr) -> bool:
    return arr._grad_req not in (None, "null")


def leaf(arr, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` as the data of variable ``arr``: a detached leaf that
    requires grad (integer tensors cannot), tagged with ``arr``."""
    t = tensor.detach()
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(True)
        t._mx_variable = weakref.ref(arr)
    return t


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Attach gradient buffers to arrays (reference
    ``MXAutogradMarkVariables``); marking makes each one a leaf."""
    if not isinstance(grad_reqs, (list, tuple)):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._data = leaf(v, v._data) if _is_variable(v) else v._data.detach()


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _variables_of(roots) -> List:
    """Each tagged leaf tensor reachable from the ``grad_fn`` nodes
    ``roots``, with its array: ``[(array, tensor)]``."""
    seen, stack, found = set(), list(roots), []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        t = getattr(fn, "variable", None)
        if t is not None:
            ref = getattr(t, "_mx_variable", None)
            arr = ref() if ref is not None else None
            if arr is not None and _is_variable(arr):
                found.append((arr, t))
        stack.extend(f for f, _ in fn.next_functions)
    return found


def _grads(outs, ogs, tensors, retain_graph):
    try:
        return torch.autograd.grad(outs, tensors, ogs,
                                   retain_graph=retain_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError(
                "backward through an already-freed graph: pass "
                "retain_graph=True to backward() to differentiate the same "
                "subgraph twice") from None
        raise


def _run_backward(heads, head_grads, variables=None, retain_graph=False):
    """Gradients of ``heads``: written into the variables' gradient arrays,
    or, given ``variables``, returned for them (a tensor or None each)."""
    if all(h._data.grad_fn is None and not _is_variable(h) for h in heads):
        raise MXNetError(
            "cannot differentiate: none of the heads was computed under "
            "autograd.record() or marked with attach_grad()")
    outs, ogs, leaf_heads = [], [], []
    for h, g in zip(heads, head_grads):
        if h._data.grad_fn is None:
            leaf_heads.append((h, g))
        else:
            outs.append(h._data)
            ogs.append(g)
    if variables is None:
        targets = _variables_of([o.grad_fn for o in outs])
    else:
        targets = [(v, v._data) for v in variables if v._data.requires_grad]
    got = (_grads(outs, ogs, [t for _, t in targets], retain_graph)
           if outs and targets else [None] * len(targets))
    total: Dict[int, torch.Tensor] = {}
    arrays = {}
    for (arr, _), g in list(zip(targets, got)) + leaf_heads:
        if g is None or (variables is None and not _is_variable(arr)):
            continue
        total[id(arr)] = g if id(arr) not in total else total[id(arr)] + g
        arrays[id(arr)] = arr
    if variables is not None:
        return [total.get(id(v)) for v in variables]
    for key, g in total.items():
        _write_grad(arrays[key], g)
    return None


def _write_grad(x, g) -> None:
    if x._grad is None:
        raise ValueError("array does not have gradient buffer; call "
                         "attach_grad()")
    g = g.detach()
    if x._grad_req == "add":
        x._grad._data = x._grad._data + g
    else:  # write
        x._grad._data = g.to(x._grad._data.dtype)
    x._grad._version += 1


def _head_grads(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    return [torch.ones_like(h._data) if g is None else
            (g._data if hasattr(g, "_data") else torch.as_tensor(g)).to(
                h._data.device) for h, g in zip(heads, head_grads)]


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Compute the gradients of ``heads`` with respect to every variable
    they depend on, into the variables' gradient arrays."""
    if not isinstance(heads, (list, tuple)):
        heads, head_grads = [heads], [head_grads]
    _run_backward(heads, _head_grads(heads, head_grads), None, retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    NDArrays (the variables' gradient arrays are untouched)."""
    if create_graph:
        raise NotImplementedError(
            "autograd.grad(create_graph=True) is not ported yet")
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
    from .ndarray.ndarray import NDArray
    raw = _run_backward(heads, _head_grads(heads, head_grads), variables,
                        bool(retain_graph))
    return [NDArray(torch.zeros_like(v._data.detach()) if g is None
                    else g.detach(), v.context)
            for v, g in zip(variables, raw)]


# ---------------------------------------------------------------------------
# custom functions
# ---------------------------------------------------------------------------
class _FunctionNode(torch.autograd.Function):
    """One tape node for a :class:`Function` call: ``forward`` runs the
    user's forward on the NDArrays (torch builds no graph inside it), and
    ``backward`` the user's backward on NDArrays of the output gradients."""

    @staticmethod
    def forward(ctx, fn, inputs, box, *tensors):
        with pause():
            outputs = fn.forward(*inputs)
        from .ndarray.ndarray import NDArray
        single = not isinstance(outputs, (tuple, list))
        # an input returned as an output gets an array of its own, which
        # takes the node's output tensor
        outs = [NDArray(o._data, o.context) if any(o is x for x in inputs)
                else o for o in ([outputs] if single else outputs)]
        box.append(single)
        box.extend(outs)
        ctx.fn = fn
        ctx.out_ctx = [o.context for o in outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        grads = [NDArray(g.contiguous(), c)
                 for g, c in zip(out_grads, ctx.out_ctx)]
        with pause():
            igrads = ctx.fn.backward(*grads)
        if not isinstance(igrads, (tuple, list)):
            igrads = (igrads,)
        return (None, None, None) + tuple(
            g._data if isinstance(g, NDArray) else g for g in igrads)


class Function:
    """Custom differentiable function (reference ``mx.autograd.Function``).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *out_grads)`` on NDArrays; a call under ``record()``
    records one tape node.  Both run outside the tape (under ``pause()``).
    """

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if not (is_recording() and any(on_tape(x) for x in inputs)):
            with pause():
                return self.forward(*inputs)
        box: List = []
        with torch.enable_grad():
            tensors = _FunctionNode.apply(self, inputs, box,
                                          *(x._data for x in inputs))
        single, outs = box[0], box[1:]
        for o, t in zip(outs, tensors):
            o._data = t
        return outs[0] if single else outs
