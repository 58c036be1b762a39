"""Symbol: lazy graph composition and the symbolic Executor.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py``).  A :class:`Symbol` is an immutable
DAG of op nodes over named variables, composed through the same registry
``mx.nd`` runs: :func:`invoke_symbol` adds a node, and
``ndarray.invoke`` sends Symbol inputs there, so a block's ordinary
``hybrid_forward(F, ...)`` builds a graph (:func:`trace_to_symbol`).

Where the JAX package compiles a bound graph with XLA and differentiates
it with ``jax.vjp``, the port walks it eagerly through ``ndarray.invoke``
(:func:`_eval_graph`) and differentiates it with torch autograd
(:class:`Executor`).  Shape and dtype inference run each op on
``device="meta"`` tensors, which carry shapes only; a kernel wrapper
given a meta tensor takes its plain version for the shapes.

The JSON layout (nodes / arg_nodes / heads, attrs as JSON or Python
reprs) is the JAX package's, so a symbol saved by either package loads in
the other.
"""
from __future__ import annotations

import ast
import json
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import autograd
from ..base import (MXNetError, attr_truthy, dtype_torch, narrow_source,
                    numpy_dtype)
from ..context import current_context
from ..ndarray.ndarray import NDArray, invoke as _nd_invoke
from ..ops import registry as _registry

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "invoke_symbol", "Executor", "trace_to_symbol", "NameManager"]


class ResolvedName(str):
    """A node name that already went through :meth:`NameManager.resolve`;
    resolving it again leaves it as it is (no double prefix)."""


class NameManager:
    """Names for anonymous op nodes (``fullyconnected0``), per process;
    an active ``mx.name.NameManager``/``Prefix`` scope names them
    instead."""

    _counters: Dict[str, int] = {}

    @staticmethod
    def _scope():
        from .. import name as _name_mod
        if getattr(_name_mod._tls, "stack", None):
            return _name_mod.current()
        return None

    @classmethod
    def next_name(cls, op_name: str) -> str:
        base = op_name.lower().lstrip("_")
        scope = cls._scope()
        if scope is not None:
            return scope.get(None, base)
        n = cls._counters.get(base, 0)
        cls._counters[base] = n + 1
        return f"{base}{n}"

    @classmethod
    def resolve(cls, name: Optional[str], op_name: str) -> str:
        """A node's name: explicit names also take an active scope's
        prefix."""
        if isinstance(name, ResolvedName):
            return str(name)
        scope = cls._scope()
        if scope is not None:
            return scope.get(name, op_name.lower().lstrip("_"))
        return name or cls.next_name(op_name)

    @classmethod
    def reset(cls):
        cls._counters = {}


class _Node:
    """One graph node: a variable (``op`` is None) or an op application."""

    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs")

    def __init__(self, op: Optional[str], name: str,
                 inputs: Sequence[Tuple["_Node", int]], attrs: Dict[str, Any],
                 num_outputs: int = 1):
        self.op = op
        self.name = name
        self.inputs = list(inputs)
        self.attrs = dict(attrs)
        self.num_outputs = num_outputs

    @property
    def is_var(self) -> bool:
        return self.op is None


def _topo(nodes_out: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    """Post-order of the graph under ``nodes_out``, iterative so that a
    deep graph does not reach Python's recursion limit."""
    order: List[_Node] = []
    seen = set()
    for root, _ in nodes_out:
        if id(root) in seen:
            continue
        stack: List[Tuple[_Node, bool]] = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for parent, _ in reversed(node.inputs):
                if id(parent) not in seen:
                    stack.append((parent, False))
    return order


def _params_of(node: _Node) -> Dict[str, Any]:
    """A node's op params: its attrs without the ``__x__`` bookkeeping."""
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


class Symbol:
    """An immutable view over one or more node outputs."""

    def __init__(self, outputs: Sequence[Tuple[_Node, int]]):
        self._outputs: List[Tuple[_Node, int]] = list(outputs)

    # ------------------------------------------------------------ structure
    @property
    def name(self) -> str:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return "grouped"

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for out in self._outputs:
            yield Symbol([out])

    def __getitem__(self, index):
        if isinstance(index, str):
            for node in _topo(self._outputs):
                for i in range(node.num_outputs):
                    if _out_name(node, i) == index:
                        return Symbol([(node, i)])
            raise MXNetError(f"no output named {index!r}")
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def get_internals(self) -> "Symbol":
        """Every node output of the graph, grouped."""
        return Symbol([(node, i) for node in _topo(self._outputs)
                       for i in range(node.num_outputs)])

    def _aux_var_ids(self):
        """Variables wired into the statistics inputs of a BatchNorm node
        (classified per input slot, as the reference's
        FListAuxiliaryStates, so a variable shared with another graph is
        not marked there)."""
        aux = set()
        for n in _topo(self._outputs):
            for pos in _AUX_INPUT_POSITIONS.get(n.op, ()):
                if pos < len(n.inputs) and n.inputs[pos][0].is_var:
                    aux.add(id(n.inputs[pos][0]))
        return aux

    def list_arguments(self) -> List[str]:
        aux_ids = self._aux_var_ids()
        return [n.name for n in _topo(self._outputs)
                if n.is_var and not n.attrs.get("__aux__")
                and id(n) not in aux_ids]

    def list_auxiliary_states(self) -> List[str]:
        aux_ids = self._aux_var_ids()
        return [n.name for n in _topo(self._outputs)
                if n.is_var and (n.attrs.get("__aux__") or id(n) in aux_ids)]

    def list_outputs(self) -> List[str]:
        return [_out_name(node, i) for node, i in self._outputs]

    @staticmethod
    def _public_attrs(node) -> Dict[str, str]:
        return {k: str(v) for k, v in node.attrs.items()
                if not k.startswith("__")}

    def list_attr(self) -> Dict[str, str]:
        return self._public_attrs(self._outputs[0][0])

    def attr(self, key):
        return self.list_attr().get(key)

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in _topo(self._outputs):
            a = self._public_attrs(node)
            if a:
                out[node.name] = a
        return out

    # -------------------------------------------------------------- compose
    def __copy__(self):
        return Symbol(list(self._outputs))

    def _binary(self, op, scalar_op, other, reflected=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reflected else (self, other)
            return invoke_symbol(op, [a, b], {})
        return invoke_symbol(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o): return self._binary("broadcast_add", "_plus_scalar", o)
    def __radd__(self, o): return self._binary("broadcast_add", "_plus_scalar", o)
    def __sub__(self, o): return self._binary("broadcast_sub", "_minus_scalar", o)
    def __rsub__(self, o): return self._binary("broadcast_sub", "_rminus_scalar", o, True)
    def __mul__(self, o): return self._binary("broadcast_mul", "_mul_scalar", o)
    def __rmul__(self, o): return self._binary("broadcast_mul", "_mul_scalar", o)
    def __truediv__(self, o): return self._binary("broadcast_div", "_div_scalar", o)
    def __rtruediv__(self, o): return self._binary("broadcast_div", "_rdiv_scalar", o, True)
    def __pow__(self, o): return self._binary("broadcast_power", "_power_scalar", o)
    def __mod__(self, o): return self._binary("broadcast_mod", "_mod_scalar", o)
    def __neg__(self): return invoke_symbol("negative", [self], {})

    def __eq__(self, o):  # structural identity (the reference's handle)
        if isinstance(o, Symbol):
            return self._outputs == o._outputs
        return NotImplemented

    def __hash__(self):
        return hash(tuple((id(node), idx) for node, idx in self._outputs))

    # ------------------------------------------------------------ inference
    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``; three Nones when the
        given shapes do not determine them all."""
        res = self._infer(kwargs)
        return (None, None, None) if res is None else res[0]

    def infer_type(self, **kwargs):
        """``(arg_dtypes, out_dtypes, aux_dtypes)`` as numpy dtypes; needs
        the shapes as well (declared on the variables), else three
        Nones."""
        res = self._infer({}, dtypes=dict(kwargs))
        return (None, None, None) if res is None else res[1]

    def _infer(self, shape_kwargs, dtypes: Optional[Dict] = None):
        """Fixpoint inference over ``meta`` tensors: an op node whose
        inputs are all known runs on meta tensors of their shapes and
        dtypes; an op with an ``infer_shapes`` hook fills its unknown
        variable inputs (weight, bias) from its data input, the role of
        the reference's bidirectional pass.  Returns ``((arg, out, aux)
        shapes, (arg, out, aux) numpy dtypes)``, or None."""
        nodes = _topo(self._outputs)
        dtypes = dtypes or {}
        known: Dict[Tuple[int, int], torch.Tensor] = {}

        def meta(shape, dt):
            return torch.empty(tuple(shape), dtype=dtype_torch(dt),
                               device="meta")

        for node in nodes:
            if not node.is_var:
                continue
            shape = shape_kwargs.get(node.name, node.attrs.get("__shape__"))
            if shape is None or any(s in (0, -1) for s in shape):
                continue
            known[(id(node), 0)] = meta(shape, dtypes.get(
                node.name, node.attrs.get("__dtype__") or "float32"))

        def op_eval(node):
            op = _registry.get(node.op)
            params = _params_of(node)
            if op.takes_training:
                params["_training"] = False
            ins = [known[(id(p), i)] for p, i in node.inputs]
            with torch.no_grad():
                out = (op.fn(ins, **params)
                       if node.attrs.get("__num_args__") is not None
                       else op.fn(*ins, **params))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                known[(id(node), i)] = o

        changed = True
        while changed:
            changed = False
            for node in nodes:
                if node.is_var or (id(node), 0) in known:
                    continue
                in_known = [(id(p), i) in known for p, i in node.inputs]
                if all(in_known):
                    op_eval(node)
                    changed = True
                    continue
                op = _registry.get(node.op)
                if op.infer_shapes is None:
                    continue
                shapes = [tuple(known[(id(p), i)].shape) if k else None
                          for (p, i), k in zip(node.inputs, in_known)]
                filled = op.infer_shapes(shapes, _params_of(node))
                if filled is None:
                    continue
                ref_dtype = next((known[(id(p), i)].dtype for (p, i), k in
                                  zip(node.inputs, in_known) if k), None)
                for (p, i), k, shp in zip(node.inputs, in_known, filled):
                    if k or shp is None or not p.is_var:
                        continue
                    dt = dtypes.get(p.name, p.attrs.get("__dtype__")) or (
                        ref_dtype if ref_dtype is not None else "float32")
                    known[(id(p), i)] = meta(shp, dt)
                    changed = True

        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        by_name = {n.name: known.get((id(n), 0)) for n in nodes if n.is_var}
        if any(by_name.get(n) is None for n in arg_names + aux_names) or \
                any((id(n), i) not in known for n, i in self._outputs):
            return None
        args = [by_name[n] for n in arg_names]
        outs = [known[(id(n), i)] for n, i in self._outputs]
        aux = [by_name[n] for n in aux_names]

        def shapes(ts):
            return [tuple(t.shape) for t in ts]

        def types(ts):
            return [numpy_dtype(t.dtype) for t in ts]
        return ((shapes(args), shapes(outs), shapes(aux)),
                (types(args), types(outs), types(aux)))

    # ----------------------------------------------------------- eval / bind
    def eval_with(self, bindings: Dict[str, NDArray], training: bool = False):
        """Evaluate with ``name -> NDArray`` bindings (SymbolBlock's
        forward): one output as an NDArray, several as a list."""
        outs = _eval_graph(self._outputs, dict(bindings), training)
        return outs[0] if len(outs) == 1 else outs

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Allocate the arguments (zeros) from shape hints and bind."""
        from ..ndarray import ndarray as _nd
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind: cannot infer all argument shapes; "
                             "pass shapes for every free variable")
        type_dict = type_dict or {}
        args = OrderedDict(
            (name, _nd.zeros(shape, ctx, dtype=type_dict.get(name,
                                                            "float32")))
            for name, shape in zip(self.list_arguments(), arg_shapes))
        aux = OrderedDict(
            (name, _nd.zeros(shape, ctx, dtype=type_dict.get(name,
                                                            "float32")))
            for name, shape in zip(self.list_auxiliary_states(), aux_shapes))
        args_grad = None
        if grad_req != "null":
            args_grad = OrderedDict(
                (k, _nd.zeros(v.shape, ctx, dtype=v.dtype))
                for k, v in args.items())
        return Executor(self, ctx, args, args_grad, grad_req, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind with explicit arrays (lists in argument order, or dicts
        by name)."""
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = OrderedDict(zip(arg_names, args))
        else:
            args = OrderedDict((k, args[k]) for k in arg_names)
        if isinstance(args_grad, (list, tuple)):
            args_grad = OrderedDict(zip(arg_names, args_grad))
        elif isinstance(args_grad, dict):
            args_grad = OrderedDict((k, args_grad[k]) for k in arg_names
                                    if k in args_grad)
        aux_names = self.list_auxiliary_states()
        if isinstance(aux_states, (list, tuple)):
            aux_states = OrderedDict(zip(aux_names, aux_states))
        else:
            aux_states = OrderedDict((k, (aux_states or {})[k])
                                     for k in aux_names)
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def reshape(self, *shape, **kwargs):
        """Fluent reshape: ``reshape(2, 3)``, ``reshape((2, 3))`` or
        ``reshape(shape=..., reverse=...)``."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if shape:
            kwargs["shape"] = tuple(shape)
        return invoke_symbol("reshape", [self], kwargs)

    # ---------------------------------------------------------- persistence
    def tojson(self) -> str:
        nodes = _topo(self._outputs)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_var else n.op,
            "name": n.name,
            "attrs": {k: v if isinstance(v, str) else json.dumps(v)
                      for k, v in n.attrs.items()},
            "inputs": [[nid[id(p)], i, 0] for p, i in n.inputs],
        } for n in nodes]
        heads = [[nid[id(n)], i, 0] for n, i in self._outputs]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_var]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10600]}},
                          indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        return f"<Symbol {self.name}>"


def _out_name(node: _Node, idx: int) -> str:
    if node.num_outputs == 1:
        return node.name + ("_output" if not node.is_var else "")
    return f"{node.name}_output{idx}"


# ------------------------------------------------------------ constructors
def var(name: str, attr=None, shape=None, dtype=None, **kwargs) -> Symbol:
    """A free variable with the user attributes ``attr``/``kwargs``;
    ``shape`` and ``dtype`` declare it for inference."""
    attrs = dict(attr or {})
    attrs.update(kwargs)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype if isinstance(dtype, str) else str(
            _np.dtype(dtype))
    return Symbol([(_Node(None, name, [], attrs), 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([out for s in symbols for out in s._outputs])


# ops whose trailing outputs (statistics) stay hidden from composition
# unless output_mean_var is set (the reference's FNumVisibleOutputs)
_VISIBLE_NOUT = {"BatchNorm": 1, "LayerNorm": 1}

# BatchNorm's inputs 3 and 4 are auxiliary states by position; a training
# evaluation updates them (see _eval_graph)
_BN_STAT_OPS = {"BatchNorm"}
_AUX_INPUT_POSITIONS = {name: (3, 4) for name in _BN_STAT_OPS}


def invoke_symbol(op_name: str, inputs: Sequence[Symbol],
                  params: Dict[str, Any], name: Optional[str] = None
                  ) -> Symbol:
    """Compose an op node: the symbolic counterpart of ``invoke``."""
    op = _registry.get(op_name)
    ins: List[Tuple[_Node, int]] = []
    n_group = None
    for x in inputs:
        if isinstance(x, Symbol):
            ins.extend(x._outputs)
        elif isinstance(x, (list, tuple)):
            n_group = len(x)
            for e in x:
                ins.extend(e._outputs)
        else:
            raise MXNetError(f"symbol op {op_name}: non-symbol input "
                             f"{type(x)}")
    attrs = dict(params)
    if n_group is not None:
        attrs["__num_args__"] = n_group
    nout = _resolve_nout(op, attrs)
    node = _Node(op.name, NameManager.resolve(name, op.name), ins, attrs,
                 num_outputs=nout)
    visible = _VISIBLE_NOUT.get(op.name, nout)
    if visible < nout and not attr_truthy(attrs.get("output_mean_var",
                                                    False)):
        return Symbol([(node, i) for i in range(visible)])
    return Symbol([(node, i) for i in range(nout)])


def _resolve_nout(op, attrs: Dict[str, Any]) -> int:
    """A node's output count; a dynamic (-1) op reads it from its attrs,
    as the reference's FNumOutputs reads its params."""
    if op.nout != -1:
        return op.nout
    for key in ("num_outputs", "__num_args__", "num_sections"):
        if key in attrs:
            return int(attrs[key])
    return 1


# --------------------------------------------------------------- evaluation
def _eval_graph(outputs: Sequence[Tuple[_Node, int]],
                bindings: Dict[str, Any], training: bool) -> List[NDArray]:
    """Walk the graph through ``ndarray.invoke``, with
    ``autograd.is_training()`` set to ``training``.  In training, each
    BatchNorm node's moving statistics (bound variables at inputs 3 and 4)
    take the EMA of its batch statistics in ``bindings`` (the reference's
    kernel mutates these aux states)."""
    values: Dict[int, List[NDArray]] = {}
    prev = autograd.set_training(training)
    try:
        for node in _topo(outputs):
            if node.is_var:
                if node.name not in bindings:
                    raise MXNetError(f"unbound variable {node.name}")
                v = bindings[node.name]
                values[id(node)] = [v if isinstance(v, NDArray)
                                    else NDArray(torch.as_tensor(v))]
                continue
            in_vals = [values[id(p)][i] for p, i in node.inputs]
            params = _params_of(node)
            if node.attrs.get("__num_args__") is not None:
                out = _nd_invoke(node.op, [in_vals], params)
            else:
                out = _nd_invoke(node.op, in_vals, params)
            out = out if isinstance(out, list) else [out]
            values[id(node)] = out
            if training and node.op in _BN_STAT_OPS and len(out) >= 3 and \
                    not attr_truthy(params.get("use_global_stats", False)):
                m = float(params.get("momentum", 0.9))
                for pos, stat in ((3, out[1]), (4, out[2])):
                    pnode = node.inputs[pos][0]
                    if pnode.is_var and pnode.name in bindings:
                        bindings[pnode.name] = (bindings[pnode.name] * m
                                                + stat * (1.0 - m))
    finally:
        autograd.set_training(prev)
    return [values[id(n)][i] for n, i in outputs]


# ----------------------------------------------------------------- executor
class Executor:
    """A bound symbol (reference ``include/mxnet/executor.h``).

    ``forward`` walks the graph eagerly through the registry; with
    ``is_train`` it runs in training mode and records onto torch
    autograd, updates the BatchNorm moving statistics in ``aux_dict``,
    and keeps the graph for ``backward``, which writes (``grad_req``
    ``'write'``), adds (``'add'``) or skips (``'null'``) each argument's
    gradient in ``grad_dict``.  Each graph serves one ``backward``: a
    new ``forward`` drops the previous one before it walks, and
    ``backward`` frees it as it goes, so one step's activations never
    live beside the next step's."""

    def __init__(self, symbol: Symbol, ctx, args: "OrderedDict[str, NDArray]",
                 args_grad: Optional["OrderedDict[str, NDArray]"], grad_req,
                 aux_states: "OrderedDict[str, NDArray]"):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self.arg_dict = args
        self.grad_dict = args_grad or OrderedDict()
        self.aux_dict = aux_states
        if isinstance(grad_req, str):
            grad_req = {k: grad_req for k in args}
        self._grad_req = {k: grad_req.get(k, "null") for k in args}
        self.outputs: List[NDArray] = []
        self._graph = None

    @property
    def output_dict(self):
        return OrderedDict(zip(self._symbol.list_outputs(), self.outputs))

    def _leaf(self, name: str, arr: NDArray, is_train: bool) -> NDArray:
        """The binding of an argument: its tensor, a fresh autograd leaf
        when it takes a gradient."""
        t = arr._data.detach()
        if is_train and self._grad_req.get(name, "null") != "null" and \
                name in self.grad_dict and t.is_floating_point():
            t = t.requires_grad_(True)
        return NDArray(t, arr.context)

    def forward(self, is_train: bool = False, **kwargs):
        self._graph = None
        for k, v in kwargs.items():
            if k in self.arg_dict:
                # rebound at the input's shape, as the JAX package does: a
                # batch of another size runs the graph at that size
                bound = self.arg_dict[k]._data
                t = v._data if isinstance(v, NDArray) else torch.as_tensor(
                    narrow_source(_np.asarray(v)))
                self.arg_dict[k]._set_data(t.detach().to(
                    device=bound.device, dtype=bound.dtype, copy=True))
        bindings = {k: self._leaf(k, v, is_train)
                    for k, v in self.arg_dict.items()}
        bindings.update((k, NDArray(v._data.detach(), v.context))
                        for k, v in self.aux_dict.items())
        leaves = {k: bindings[k]._data for k in self.arg_dict}
        with autograd._RecordingState(bool(is_train), None):
            outs = _eval_graph(self._symbol._outputs, bindings,
                               bool(is_train))
        for name, arr in self.aux_dict.items():
            arr._set_data(bindings[name]._data.detach())
        raw = [o._data for o in outs]
        self._graph = (leaves, raw) if is_train else None
        self.outputs = [NDArray(r.detach(), o.context)
                        for r, o in zip(raw, outs)]
        return self.outputs

    def backward(self, out_grads=None):
        if self._graph is None:
            raise MXNetError("backward called without forward(is_train=True)")
        leaves, raw = self._graph
        self._graph = None
        if out_grads is None:
            cts = [torch.ones_like(r) for r in raw]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [g._data for g in out_grads]
        pairs = [(r, c) for r, c in zip(raw, cts) if r.requires_grad]
        wrt = [(k, t) for k, t in leaves.items() if t.requires_grad]
        grads = torch.autograd.grad(
            [r for r, _ in pairs], [t for _, t in wrt],
            [c for _, c in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt)
        for (name, t), g in zip(wrt, grads):
            g = torch.zeros_like(t) if g is None else g.detach()
            tgt = self.grad_dict[name]
            if self._grad_req[name] == "add":
                tgt._set_data(tgt._data + g)
            else:
                tgt._set_data(g.to(tgt._data.dtype))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params: bool = False):
        for table, given, what in ((self.arg_dict, arg_params, "argument"),
                                   (self.aux_dict, aux_params, "aux state")):
            for k, v in (given or {}).items():
                if k in table:
                    table[k][:] = v
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes; arrays whose shape stays
        are shared, the others are new zeros."""
        from ..ndarray import ndarray as _nd
        shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def fit(table, new_shapes):
            return OrderedDict(
                (name, old if tuple(old.shape) == tuple(shp) else
                 _nd.zeros(shp, old.context, dtype=old.dtype))
                for (name, old), shp in zip(table.items(), new_shapes))
        args = fit(self.arg_dict, shapes)
        aux = fit(self.aux_dict, aux_shapes)
        grads = None
        if self.grad_dict:
            grads = OrderedDict(
                (k, _nd.zeros(v.shape, v.context, dtype=v.dtype))
                for k, v in args.items() if k in self.grad_dict)
        return Executor(self._symbol, self._ctx, args, grads, self._grad_req,
                        aux)


# ------------------------------------------------------------- persistence
def load_json(json_str: str) -> Symbol:
    """A symbol from JSON; string attrs that are JSON or Python reprs
    (``'False'``, ``'(1, 1)'``) become values, plain words stay strings."""
    g = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in g["nodes"]:
        attrs = {}
        for k, v in (jn.get("attrs") or {}).items():
            if not isinstance(v, str):
                attrs[k] = v
                continue
            try:
                attrs[k] = json.loads(v)
                continue
            except (json.JSONDecodeError, TypeError):
                pass
            try:
                attrs[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                attrs[k] = v
        op = None if jn["op"] == "null" else jn["op"]
        inputs = [(nodes[i], oi) for i, oi, _ in jn["inputs"]]
        n_out = 1 if op is None else _resolve_nout(_registry.get(op), attrs)
        nodes.append(_Node(op, jn["name"], inputs, attrs, num_outputs=n_out))
    return Symbol([(nodes[i], oi) for i, oi, _ in g["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# ------------------------------------------------------------ gluon bridge
def trace_to_symbol(block, *input_names) -> Symbol:
    """A block as a Symbol: the block called on variables (``data`` by
    default) composes its graph through ``hybrid_forward(F=mx.sym, ...)``
    (the reference's ``_get_graph``)."""
    inputs = [var(n) for n in (list(input_names) or ["data"])]
    out = block(*inputs)
    return out if isinstance(out, Symbol) else Group(list(out))
