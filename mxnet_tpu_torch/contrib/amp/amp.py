"""AMP for the port: parameter conversion, op-level autocast and dynamic
loss scaling (counterpart of ``mxnet_tpu/contrib/amp/amp.py``; reference
``python/mxnet/contrib/amp/amp.py`` and ``loss_scaler.py``).

Autocast casts an op's float inputs by the op lists (``lists.py``) where
the JAX package's ``invoke`` casts: in ``ndarray.invoke`` (so ``mx.nd``,
``mx.sym`` graphs through ``Symbol.eval_with`` and the ``Executor``, and
every ``hybrid_forward`` over ``mx.nd``), and in the Gluon layers'
tensor ``forward``s, which call the ops' functions through ``ops.F``
(``ops/registry.py``, ``OpNamespace``).  The casts are torch ops, so
autograd records them: a backward replays the forward's casts whatever
the policy is by then, a ``create_graph`` backward differentiates them,
and a CUDA graph captured under a policy records them (``CachedOp``, the ``Executor`` and
``CompiledTrainStep`` key their entries on :func:`snapshot`).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from . import lists

_LOW_FLOATS = (torch.bfloat16, torch.float16)
# Norm-layer parameters and running statistics stay fp32 under conversion
# (the reference keeps BatchNorm in FP32_FUNCS).
_FP32_PARAM_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                        "moving_mean", "moving_var")
_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_FLOATS = ("float16", "bfloat16", "float32", "float64")

_state = {"active": False, "target": None}


def _target_dtype(name: str) -> torch.dtype:
    if name not in _TARGETS:
        raise ValueError(f"target_dtype must be bfloat16 or float16, got "
                         f"{name!r}")
    return _TARGETS[name]


def init(target_dtype: str = "bfloat16") -> None:
    """Turn op-level autocast on for the process (reference
    ``amp.init``): the low-precision list's inputs are cast to
    ``target_dtype``, the fp32 list's up to fp32, and the widest list's to
    the widest float among them."""
    _state["target"] = _target_dtype(target_dtype)
    _state["active"] = True
    _state.pop("_snapshot", None)


def deinit() -> None:
    _state["active"] = False
    _state.pop("_snapshot", None)


def is_active() -> bool:
    return _state["active"]


def snapshot():
    """The active policy as a hashable tuple ``(target, low-precision
    override, fp32 override)``, or None when autocast is off; cached until
    the policy changes.  The graph caches key on it."""
    if not _state["active"]:
        return None
    snap = _state.get("_snapshot")
    if snap is None:
        lp, f32 = _state.get("policy_lp"), _state.get("policy_fp32")
        snap = (str(_state["target"]).replace("torch.", ""),
                None if lp is None else frozenset(lp),
                None if f32 is None else frozenset(f32))
        _state["_snapshot"] = snap
    return snap


def autocast_arrays(op_name: str, raws, snap=None):
    """``raws`` (tensors, non-tensors and nested lists of a variadic op)
    with the float tensors cast as the policy says for ``op_name``.  A
    ``convert_symbol`` policy (:func:`policy_scope`) replaces the default
    lists; an op the user named in ``target_dtype_ops`` runs in low
    precision even when the default fp32 list holds it (only an explicit
    ``fp32_ops`` entry outranks it).  ``snap`` replays a captured policy
    instead of the live one."""
    if snap is not None:
        target, policy_lp, policy_f32 = (_TARGETS[snap[0]], snap[1],
                                         snap[2])
    else:
        target = _state["target"]
        policy_lp = _state.get("policy_lp")      # None: not overridden
        policy_f32 = _state.get("policy_fp32")
    lp_set = lists.LOW_PRECISION_OPS if policy_lp is None else policy_lp
    f32_set = lists.FP32_OPS if policy_f32 is None else policy_f32
    if (policy_lp is not None and op_name in policy_lp
            and not (policy_f32 is not None and op_name in policy_f32)) \
            or (op_name not in f32_set and op_name in lp_set):
        want = target
    elif op_name in f32_set:
        return _map_tensors(lambda t: t.float() if t.dtype in _LOW_FLOATS
                            else t, raws)
    elif op_name in lists.WIDEST_OPS:
        floats = [t.dtype for t in _flat_tensors(raws)
                  if t.is_floating_point()]
        if not floats:
            return raws
        want = max(floats, key=lambda d: torch.finfo(d).bits)
    else:
        return raws
    return _map_tensors(lambda t: t.to(want) if t.is_floating_point()
                        and t.dtype != want else t, raws)


@contextlib.contextmanager
def policy_scope(policy):
    """Run a ``convert_symbol`` policy while a graph evaluates: its
    ``target_dtype_ops``/``fp32_ops`` replace the default lists (when
    given) and decide the executed precision.  ``policy`` None is a
    no-op."""
    if not policy:
        yield
        return
    prev = dict(_state)
    _state["active"] = True
    _state["target"] = _target_dtype(policy.get("target_dtype")
                                     or "float16")
    lp, f32 = policy.get("target_dtype_ops"), policy.get("fp32_ops")
    _state["policy_lp"] = None if lp is None else set(lp)
    _state["policy_fp32"] = None if f32 is None else set(f32)
    _state.pop("_snapshot", None)
    try:
        yield
    finally:
        _state.clear()
        _state.update(prev)


@contextlib.contextmanager
def suspend_scope():
    """Autocast off for one op (the nodes of ``excluded_sym_names``)."""
    prev = _state["active"]
    _state["active"] = False
    try:
        yield
    finally:
        _state["active"] = prev


def _flat_tensors(raws):
    for x in raws:
        if isinstance(x, (list, tuple)):
            yield from _flat_tensors(x)
        elif isinstance(x, torch.Tensor):
            yield x


def _map_tensors(fn, raws):
    out = []
    for x in raws:
        if isinstance(x, (list, tuple)):
            out.append(type(x)(_map_tensors(fn, x)))
        elif isinstance(x, torch.Tensor):
            out.append(fn(x))
        else:
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# Model conversion (reference convert_model / convert_hybrid_block)
# ---------------------------------------------------------------------------
def convert_block(net, target_dtype: str = "bfloat16",
                  excluded_params: Optional[set] = None):
    """Cast every fp32 parameter and buffer of ``net`` to ``target_dtype``
    in place, except those whose name (``state_dict`` key) ends in a norm
    suffix and those named in ``excluded_params``; returns ``net``."""
    dtype = _target_dtype(target_dtype)
    excluded = excluded_params or set()
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        if name in excluded or name.endswith(_FP32_PARAM_SUFFIXES):
            continue
        if t.dtype == torch.float32:
            t.data = t.data.to(dtype)
    net._amp_dtype = target_dtype
    return net


def convert_hybrid_block(net, target_dtype: str = "bfloat16", **kwargs):
    """Reference-name alias: hybridized and eager blocks convert alike."""
    return convert_block(net, target_dtype, **kwargs)


# ---------------------------------------------------------------------------
# Dynamic loss scaling (reference contrib/amp/loss_scaler.py)
# ---------------------------------------------------------------------------
class LossScaler:
    """Dynamic loss scale: doubled after ``growth_interval`` finite steps,
    halved (down to 1) on an overflow, whose update is skipped.  bf16
    shares fp32's exponent range, so its scale defaults to 1, an identity
    that checks nothing; fp16 starts at 2**15.  A scaler that starts above
    1 stays dynamic even after it decays to 1."""

    def __init__(self, init_scale: Optional[float] = None,
                 growth_interval: int = 2000,
                 target_dtype: str = "bfloat16"):
        if init_scale is None:
            init_scale = 1.0 if target_dtype == "bfloat16" else 2.0 ** 15
        self.loss_scale = float(init_scale)
        self.growth_interval = growth_interval
        self._unskipped = 0
        self.dynamic = self.loss_scale > 1.0

    def has_overflow(self, grads) -> bool:
        """True if any gradient holds a non-finite value: one multi-tensor
        check on their device (``torch._amp_foreach_non_finite_check_and_
        unscale_`` at a scale of 1, which leaves finite values as they
        are) and one host read."""
        from ...ndarray.ndarray import NDArray
        raws = [(g._data if isinstance(g, NDArray) else g).detach()
                for g in grads]
        if not raws:
            return False
        found = torch.zeros((), dtype=torch.float32, device=raws[0].device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            raws, found, torch.ones_like(found))
        return bool(found.item())

    def update_scale(self, skip: bool) -> None:
        if skip:
            self.loss_scale = max(self.loss_scale / 2.0, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.growth_interval:
                self.loss_scale = min(self.loss_scale * 2.0, 2.0 ** 24)
                self._unskipped = 0


def unscale(trainer):
    """Divide the trainer's gradients by the loss scale in place and put
    its rescale factor back (reference ``amp.unscale``), for code that
    needs the true gradients (clipping, norm logging) between backward and
    step."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req != "null" and p._allocated():
                p.grad()._data.mul_(inv)
    trainer._scale = getattr(trainer, "_amp_original_scale", trainer._scale)
    trainer._amp_scale_folded = False


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled:
    autograd.backward(scaled)``: the loss times the scale, with its
    inverse folded into the trainer's gradient rescale for the next
    ``step()``, which skips an update whose gradients overflowed and
    updates the scale."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        scaler = LossScaler(target_dtype=getattr(trainer, "_amp_dtype",
                                                 "bfloat16"))
        trainer._amp_loss_scaler = scaler
    if not getattr(trainer, "_amp_scale_folded", False):
        # the true rescale is taken only when not folded already: a second
        # scale_loss before a step must not compound
        trainer._amp_original_scale = trainer._scale
        trainer._amp_scale_folded = True
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale

    def _scaled(l):
        if scaler.loss_scale == 1.0:
            return l  # identity: no node on the tape
        # scale_loss is usually entered after record(): the product must
        # still be recorded, or backward through it would be a no-op
        from ... import autograd
        with autograd.record():
            return l * scaler.loss_scale

    if isinstance(loss, (list, tuple)):
        yield [_scaled(l) for l in loss]
    else:
        yield _scaled(loss)


# ---------------------------------------------------------------------------
# List getters and symbolic conversion (reference contrib/amp/amp.py)
# ---------------------------------------------------------------------------
def list_fp16_ops(target_dtype="float16"):
    """Ops whose inputs go to the low-precision dtype."""
    return sorted(lists.LOW_PRECISION_OPS)


def list_fp32_ops(target_dtype="float16"):
    return sorted(lists.FP32_OPS)


def list_fp16_fp32_ops(target_dtype="float16"):
    """Ops that run in either precision: every registered op in neither
    list."""
    from ...ops.registry import REGISTRY
    listed = lists.LOW_PRECISION_OPS | lists.FP32_OPS
    return sorted(n for n in REGISTRY if n not in listed)


def list_conditional_fp32_ops(target_dtype="float16"):
    """The reference keeps some ops fp32 per parameter value; here the
    sensitive set is unconditional, so none."""
    return []


def init_trainer(trainer):
    """Dynamic loss scaling for a ``gluon.Trainer`` (reference
    ``amp.init_trainer``), following the active target: fp16 starts at
    2**15 and grows, bf16 stays at 1."""
    target = (str(_state["target"]).replace("torch.", "")
              if _state.get("active") and _state.get("target") is not None
              else "bfloat16")
    trainer._amp_loss_scaler = LossScaler(target_dtype=target)
    trainer._amp_original_scale = getattr(trainer, "_scale", 1.0)


def convert_symbol(sym, target_dtype="float16", target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, cast_optional_params=False):
    """A copy of ``sym`` that evaluates under an AMP policy (reference
    ``convert_symbol``, which rewrites the graph with ``amp_cast`` nodes):
    the dtype, the list overrides and the excluded node names ride on the
    symbol, and ``Symbol.eval_with`` and the ``Executor`` evaluate it
    inside :func:`policy_scope`."""
    _target_dtype(target_dtype)
    out = sym.__class__(sym._outputs)
    out._amp_policy = {"target_dtype": target_dtype,
                       "target_dtype_ops": target_dtype_ops,
                       "fp32_ops": fp32_ops,
                       "excluded": excluded_sym_names}
    return out


def convert_model(sym, arg_params, aux_params, target_dtype="float16",
                  excluded_sym_names=None, cast_optional_params=False,
                  **kwargs):
    """``(converted symbol, arg_params, aux_params)`` with the float
    parameters cast (reference ``convert_model``).  Parameters that feed an
    excluded node stay fp32; the aux parameters (BatchNorm's moving
    statistics, the reference's optional ones) are cast only with
    ``cast_optional_params``.  The dicts hold NDArrays or numpy arrays."""
    from ...symbol.symbol import _topo
    csym = convert_symbol(sym, target_dtype,
                          excluded_sym_names=excluded_sym_names, **kwargs)
    keep_fp32 = set()
    excluded = set(excluded_sym_names or [])
    if excluded:
        for node in _topo(sym._outputs):
            if not node.is_var and node.name in excluded:
                keep_fp32.update(p.name for p, _ in node.inputs if p.is_var)

    def _cast_dict(d, enabled=True):
        out = {}
        for k, v in d.items():
            if enabled and k not in keep_fp32 and str(v.dtype) in _FLOATS:
                out[k] = v.astype(target_dtype)
            else:
                out[k] = v
        return out
    return (csym, _cast_dict(arg_params),
            _cast_dict(aux_params, enabled=cast_optional_params))


def convert_bucketing_module(bucketing_mod, target_dtype="float16",
                             **kwargs):
    """A ``BucketingModule`` whose ``sym_gen`` gives converted symbols
    (reference ``convert_bucketing_module``)."""
    from ...module import BucketingModule
    old_gen = bucketing_mod._sym_gen

    def gen(bucket_key):
        sym, data_names, label_names = old_gen(bucket_key)
        return (convert_symbol(sym, target_dtype, **kwargs), data_names,
                label_names)

    return BucketingModule(gen, bucketing_mod._default_bucket_key,
                           logger=bucketing_mod.logger)
