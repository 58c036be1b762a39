"""Training health sentinel and the serving decode-path sentinel:
numerics watchpoints, NaN/Inf localization, cross-rank divergence
checksums and spike detection.

Counterpart of ``mxnet_tpu/observability/health.py``.  Four layers over
one ledger:

* **In-graph watchpoints** — :func:`graph_stats` computes, inside
  :class:`~mxnet_tpu_torch.executor.CompiledTrainStep`'s step (so on the
  card they are outputs of the step's CUDA graph): per-parameter fp32
  sums of squares of the gradient, the updated parameter and the update
  delta, the non-finite count per gradient (int32) and the loss's.  The
  :class:`HealthMonitor` copies them to the host once every
  ``MXNET_TPU_HEALTH_EVERY`` steps and derives the global grad norm, the
  parameter norm and the update ratio ``‖Δw‖/‖w‖``
  (``mxnet_tpu_health_*`` gauges).  ``MultiStepTrainStep`` copies each
  replay's stats into a K-row device buffer.
* **NaN/Inf localization** — on a trip, :func:`localize` re-runs the step's
  forward and backward against the last *healthy* parameters (a host copy
  the monitor refreshes at each healthy fetch) through
  ``torch.func.functional_call``, so no live tensor a graph reads is
  written; each leaf block's ``forward`` is patched with a probe (and put
  back after) that names the first block whose output is non-finite
  (``first_fwd``), and the parameter gradients name the layer nearest the
  loss whose gradients are non-finite (``first_bwd``).  The dropout
  generators' states are put back after the probe, so a localization does
  not move the training run's random stream.
* **Divergence checksums** — :func:`divergence_report` folds each
  parameter's bytes into a sha256 digest (bfloat16 through its int16 view,
  so the digests equal the JAX package's for the same values) and, in a
  job of several processes, compares the digests across ranks over
  ``profiler._allgather_blobs``; the minority names the diverging rank.
* **Spike detection** — :class:`SpikeDetector`, a rolling z-score on the
  loss and the global grad norm.

Response policy (``MXNET_TPU_HEALTH_ACTION`` / ``HealthConfig.action``):
``log``, ``dump`` (flight-recorder post-mortem), ``raise``
(:class:`NumericsError`), ``skip`` (the training step only: the step's
pre-step device copy of parameters, buffers and optimizer states is
copied back in place, and its step count and the optimizer's counts are
rewound).

:func:`check_logits` is the serving decode-path sentinel (with
``MXNET_TPU_HEALTH`` set the generation scheduler copies each forward's
logits to the host and sweeps them).

Not ported: the Monitor feed of the taps (``monitor.py``, ROADMAP A15);
:func:`tap` deposits into the open capture, and the taps ride out of the
step and into the ledger's records only.
"""
from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, env as _env
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "NumericsError", "HealthConfig", "SpikeDetector", "HealthMonitor",
    "HealthLedger", "NumericsFaultPlan", "graph_stats", "global_norm",
    "global_norm_value", "clip_global_norm", "localize", "checksum_arrays",
    "divergence_report", "capture_taps", "tap", "capturing",
    "hook_fingerprint", "param_names", "ledger", "snapshot",
    "serving_sentinel_enabled", "check_logits", "ACTIONS",
]

_log = logging.getLogger("mxnet_tpu_torch.health")

ACTIONS = ("log", "dump", "raise", "skip")

_REG = _metrics.registry()
_M_NONFINITE = _REG.counter(
    "mxnet_tpu_health_nonfinite_total",
    "Non-finite values detected by the health sentinel, by surface "
    "(grad: in-graph gradient watchpoint; loss: in-graph loss watchpoint; "
    "logits: serving decode-path sentinel).", labels=("where",))
_M_SPIKES = _REG.counter(
    "mxnet_tpu_health_spikes_total",
    "Rolling z-score anomaly detections, by signal (loss / grad_norm).",
    labels=("signal",))
_M_FETCHES = _REG.counter(
    "mxnet_tpu_health_fetches_total",
    "Watchpoint device->host stat fetches (one per MXNET_TPU_HEALTH_EVERY "
    "steps per executor).")
_M_FETCH_SECONDS = _REG.histogram(
    "mxnet_tpu_health_fetch_seconds",
    "Wall time of one watchpoint stat fetch (device sync + host derivation "
    "of norms/ratios) — the cadence-amortized health overhead.",
    bucket_start=1e-6, bucket_factor=4.0, bucket_count=14)
_M_CHECKSUM_ROUNDS = _REG.counter(
    "mxnet_tpu_health_checksum_rounds_total",
    "Cross-rank divergence-checksum rounds completed.")
_M_CHECKSUM_MISMATCHES = _REG.counter(
    "mxnet_tpu_health_checksum_mismatches_total",
    "Divergence-checksum rounds whose per-rank digests disagreed (a rank's "
    "replicated state silently drifted — the SDC signature).")
_M_GRAD_NORM = _REG.gauge(
    "mxnet_tpu_health_grad_norm",
    "Last fetched global gradient L2 norm (f32 accumulation) from the "
    "in-graph watchpoints.")
_M_PARAM_NORM = _REG.gauge(
    "mxnet_tpu_health_param_norm",
    "Last fetched global parameter L2 norm from the in-graph watchpoints.")
_M_UPDATE_RATIO = _REG.gauge(
    "mxnet_tpu_health_update_ratio",
    "Last fetched update ratio ||delta w|| / ||w|| — the effective-step-"
    "size health signal (collapse toward 0 = dead training; spike = blowup).")


class NumericsError(MXNetError):
    """A numerics health violation the response policy chose to raise on:
    a non-finite sentinel trip (``where``/``detail`` name the first faulting
    layer), a divergence-checksum mismatch (``diverging_rank`` / ``keys``
    name the drifted rank), a spike with ``action='raise'``, or non-finite
    logits on the decode path."""

    def __init__(self, msg: str, where: str = "",
                 detail: Optional[Dict] = None,
                 diverging_rank: Optional[int] = None,
                 keys: Optional[List[str]] = None):
        super().__init__(msg)
        self.where = where
        self.detail = detail or {}
        self.diverging_rank = diverging_rank
        self.keys = list(keys or [])


class HealthConfig:
    """Knobs for the health sentinel; every default reads its knob
    (``MXNET_TPU_HEALTH_EVERY``, ``MXNET_TPU_HEALTH_ACTION``,
    ``MXNET_TPU_HEALTH_WINDOW``, ``MXNET_TPU_HEALTH_ZSCORE``,
    ``MXNET_TPU_HEALTH_CHECKSUM_EVERY``)."""

    def __init__(self, every: Optional[int] = None,
                 action: Optional[str] = None,
                 window: Optional[int] = None,
                 zscore: Optional[float] = None,
                 checksum_every: Optional[int] = None,
                 watchpoints: bool = True,
                 localize: bool = True):
        self.every = max(1, int(_env.MXNET_TPU_HEALTH_EVERY
                                if every is None else every))
        self.action = str(_env.MXNET_TPU_HEALTH_ACTION
                          if action is None else action).strip().lower()
        if self.action not in ACTIONS:
            raise MXNetError(f"health action {self.action!r} not in {ACTIONS}")
        if self.action == "skip":
            # skip restores the CALL's pre-step copy: at a coarser cadence
            # the NaN may be many steps old and the copy already poisoned
            self.every = 1
        self.window = max(4, int(_env.MXNET_TPU_HEALTH_WINDOW
                                 if window is None else window))
        self.zscore = float(_env.MXNET_TPU_HEALTH_ZSCORE
                            if zscore is None else zscore)
        self.checksum_every = int(_env.MXNET_TPU_HEALTH_CHECKSUM_EVERY
                                  if checksum_every is None else checksum_every)
        self.watchpoints = bool(watchpoints)
        self.localize = bool(localize)

    @classmethod
    def coerce(cls, value) -> Optional["HealthConfig"]:
        """None/False -> None; True -> env defaults; dict -> kwargs;
        an instance passes through."""
        if value is None or value is False:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        return cls()


# ===========================================================================
# in-graph watchpoints
# ===========================================================================
def _sumsq_f32(a: torch.Tensor) -> torch.Tensor:
    """THE per-tensor reduction every health consumer shares: the fp32 sum
    of squares (0-dim).  ``clip_global_norm`` and the watchpoints agree on
    it."""
    return torch.sum(torch.square(a.detach().float()))


def global_norm(raws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over tensors: per-tensor fp32 sums of squares,
    stacked, summed, square root (0-dim fp32, on the tensors' device)."""
    return torch.sqrt(torch.sum(torch.stack([_sumsq_f32(g) for g in raws])))


def global_norm_value(raws) -> float:
    """The measured global norm as a host float."""
    return float(global_norm(list(raws)))


@torch.no_grad()
def clip_global_norm(raws: Sequence[torch.Tensor], max_norm: float):
    """Scale ``raws`` so their global L2 norm is at most ``max_norm``: one
    measure-and-scale pass.  Returns ``(norm, scaled)`` (new tensors);
    within budget the tensors come back bitwise unchanged (scale 1.0 in
    fp32; other dtypes round-trip through the same fp32 cast), and the
    result equals the two-pass form (measure with :func:`global_norm`,
    then scale each tensor by the same factor) bit for bit."""
    raws = list(raws)
    norm = global_norm(raws)
    mx = torch.tensor(float(max_norm), dtype=torch.float32,
                      device=norm.device)
    scale = torch.where(norm > mx, mx / norm,
                        torch.ones((), dtype=torch.float32,
                                   device=norm.device))
    scaled = [(g.float() * scale).to(g.dtype) for g in raws]
    _M_GRAD_NORM.set(float(norm))
    return norm, scaled


@torch.no_grad()
def graph_stats(grads, old_learn, new_learn, loss, taps=None) -> Dict:
    """The watchpoint bundle, computed inside the training step.  Pure
    observation: every value is a new reduction over tensors the step
    already has, so the update (and its bitwise parity with a
    watchpoint-free step) is untouched.

    * ``grad_sq``/``param_sq``/``upd_sq`` — per-parameter fp32 sums of
      squares of the gradient, the updated parameter, and the update
      delta (``[n_params]``);
    * ``grad_nonfinite`` — per-parameter non-finite count (int32);
    * ``loss_nonfinite`` — non-finite count of the loss (int32, 0-dim);
    * ``taps`` — what :func:`tap` deposited during the forward."""
    def stack(vals, dtype=None):
        return torch.stack(vals) if vals else torch.zeros(
            (0,), dtype=dtype or torch.float32, device=loss.device)

    def nonfinite(t):
        return torch.sum(~torch.isfinite(t.detach())).to(torch.int32)

    return {
        "grad_sq": stack([_sumsq_f32(g) for g in grads]),
        "param_sq": stack([_sumsq_f32(w) for w in new_learn]),
        "upd_sq": stack([_sumsq_f32(n.detach().float() - o.float())
                         for n, o in zip(new_learn, old_learn)]),
        "grad_nonfinite": stack([nonfinite(g) for g in grads], torch.int32),
        "loss_nonfinite": nonfinite(loss),
        "taps": dict(taps or {}),
    }


# ===========================================================================
# taps: the in-step sink
# ===========================================================================
_tap_tls = threading.local()


@contextmanager
def capture_taps():
    """Open a tap sink for the duration of a step's forward: :func:`tap`
    deposits named in-step tensors here and the step returns them with its
    stats."""
    prev = getattr(_tap_tls, "sink", None)
    sink: Dict[str, Any] = {}
    _tap_tls.sink = sink
    try:
        yield sink
    finally:
        _tap_tls.sink = prev


def capturing() -> bool:
    return getattr(_tap_tls, "sink", None) is not None


def tap(name: str, value) -> None:
    """Deposit one named in-step scalar into the open capture (no-op when
    none is open).  Duplicate names get ``_2``, ``_3``... suffixes."""
    sink = getattr(_tap_tls, "sink", None)
    if sink is None:
        return
    key, i = name, 1
    while key in sink:
        i += 1
        key = f"{name}_{i}"
    sink[key] = value


def _block_name(block) -> str:
    return getattr(block, "name", None) or type(block).__name__


def hook_fingerprint(net) -> Tuple:
    """Signature salt: which modules carry forward hooks or an
    instance-level ``forward`` (a probe, a :class:`NumericsFaultPlan`).  A
    patched forward changes what a captured step records; the training
    step adds this to its graph signature when health is armed, so a plan
    entered after a capture takes a new graph."""
    if net is None or not isinstance(net, torch.nn.Module):
        return ()
    return tuple((_block_name(block), len(block._forward_hooks),
                  "forward" in vars(block))
                 for block in net.modules()
                 if block._forward_hooks or "forward" in vars(block))


# ===========================================================================
# spike detection
# ===========================================================================
class SpikeDetector:
    """Rolling z-score anomaly detector.  ``update(v)`` returns True when
    ``v`` exceeds ``mean + zscore * std`` of the trailing window (with at
    least ``min_points`` history).  Non-finite values are never added to
    the window and never flag as spikes."""

    def __init__(self, window: int = 64, zscore: float = 6.0,
                 min_points: int = 8):
        self.window = max(4, int(window))
        self.zscore = float(zscore)
        self.min_points = max(2, int(min_points))
        self._vals: deque = deque(maxlen=self.window)
        self._lock = threading.Lock()

    def update(self, value) -> bool:
        v = float(value)
        if not np.isfinite(v):
            return False
        with self._lock:
            spike = False
            if len(self._vals) >= self.min_points:
                arr = np.asarray(self._vals, dtype=np.float64)
                mean = float(arr.mean())
                # the floor keeps a flat window from flagging an ulp
                std = max(float(arr.std()), 1e-12 * max(1.0, abs(mean)))
                spike = v > mean + self.zscore * std
            self._vals.append(v)
            return spike


# ===========================================================================
# ledger (process-global; flight post-mortems embed snapshot())
# ===========================================================================
class HealthLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self.last_step: Optional[Dict[str, Any]] = None
        self._trips: deque = deque(maxlen=32)
        self._spikes: deque = deque(maxlen=64)
        self._checksums: deque = deque(maxlen=16)

    def record_step(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self.last_step = rec

    def record_trip(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._trips.append(rec)

    def record_spike(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._spikes.append(rec)

    def record_checksum(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._checksums.append(rec)

    @property
    def trips(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._trips)

    def snapshot(self) -> Dict[str, Any]:
        """The flight recorder's ``"health"`` view: last watchpoint fetch,
        sentinel trips (with localization reports), spike history,
        checksum agreement, and the counter values."""
        with self._lock:
            out = {
                "last_step": self.last_step,
                "trips": list(self._trips),
                "spikes": list(self._spikes),
                "checksums": list(self._checksums),
            }
        out["counters"] = {
            "nonfinite": _M_NONFINITE.sample_dict(),
            "spikes": _M_SPIKES.sample_dict(),
            "fetches": _M_FETCHES.value,
            "checksum_rounds": _M_CHECKSUM_ROUNDS.value,
            "checksum_mismatches": _M_CHECKSUM_MISMATCHES.value,
        }
        out["gauges"] = {
            "grad_norm": _M_GRAD_NORM.value,
            "param_norm": _M_PARAM_NORM.value,
            "update_ratio": _M_UPDATE_RATIO.value,
        }
        return out

    def _reset(self) -> None:
        with self._lock:
            self.last_step = None
            self._trips.clear()
            self._spikes.clear()
            self._checksums.clear()


_LEDGER = HealthLedger()


def ledger() -> HealthLedger:
    """The process-global health ledger."""
    return _LEDGER


def snapshot() -> Dict[str, Any]:
    return _LEDGER.snapshot()


# ===========================================================================
# response policy
# ===========================================================================
def _respond(action: str, rec: Dict[str, Any], msg: str,
             where: str = "") -> str:
    """Flight-ring breadcrumb always; then act per policy.  Returns the
    action taken (``raise`` raises)."""
    from . import flight_recorder as _fr
    _fr.record_event("health." + rec.get("kind", "event"), **{
        k: v for k, v in rec.items()
        if isinstance(v, (str, int, float, bool, type(None)))})
    if action == "raise":
        exc = NumericsError(msg, where=where, detail=rec,
                            diverging_rank=rec.get("diverging_rank"),
                            keys=rec.get("keys"))
        _fr.notify_fatal(exc, site="health")
        raise exc
    if action == "dump":
        try:
            _fr.get().dump(reason=f"health: {msg}")
        except Exception:  # noqa: BLE001 - telemetry must never break
            _log.warning("health flight dump failed", exc_info=True)
    else:
        _log.warning("health: %s", msg)
    return action


# ===========================================================================
# NaN/Inf localization
# ===========================================================================
def _patch_forward(block, wrapped, saved: List) -> None:
    """Install an instance-level forward, remembering whether the block
    already had one: restoring by assignment would leave an instance
    attribute behind, and :func:`hook_fingerprint` would report the block
    as patched forever after."""
    saved.append((block, block.forward, "forward" in vars(block)))
    block.forward = wrapped


def _restore_forwards(saved: List) -> None:
    for block, orig, had_instance_attr in reversed(saved):
        if had_instance_attr:
            block.forward = orig
        else:
            try:
                del block.forward
            except AttributeError:
                pass
    saved.clear()


def _leaf_blocks(net) -> List:
    """The modules of ``net`` with no child module, in definition order."""
    out = []

    def walk(block):
        kids = list(block.children())
        if not kids:
            out.append(block)
        for c in kids:
            walk(c)

    walk(net)
    return out


def param_names(net, tensors: Sequence[torch.Tensor]) -> List[str]:
    """The names of ``tensors`` (modules' parameters or buffers of
    ``net``): a Gluon :class:`~mxnet_tpu_torch.gluon.parameter.Parameter`'s
    prefixed name (``dense0_weight``, the JAX package's names) where a
    block registered one, else the structural name (``0.weight``)."""
    by_id: Dict[int, str] = {}
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        by_id.setdefault(id(t), name)
    for block in net.modules():
        for attr, p in getattr(block, "_reg_params", {}).items():
            t = getattr(block, attr, None)
            if isinstance(t, torch.Tensor):
                by_id[id(t)] = p.name
    return [by_id.get(id(t), f"t{i}") for i, t in enumerate(tensors)]


def _tensor_parts(net):
    """``(learn_names, aux_names)`` in the training step's orders: the
    parameters with a gradient; the others, then the buffers."""
    named = list(net.named_parameters())
    return ([n for n, p in named if p.requires_grad],
            [n for n, p in named if not p.requires_grad]
            + [n for n, _ in net.named_buffers()])


def localize(net, loss_fn, x, y, params=None) -> Dict[str, Any]:
    """Diagnostic re-execution with per-layer probes.  Names:

    * ``first_fwd`` — the first leaf block (forward execution order) whose
      output holds a non-finite value;
    * ``first_bwd`` — the layer *nearest the loss* whose parameter
      gradients are non-finite (non-finite cotangents contaminate every
      layer upstream of the fault, so the boundary layer is the culprit).

    ``x``/``y`` are tensors or NDArrays (tuples allowed); ``params`` an
    optional ``(learnable, aux)`` pair of tensor lists in the training
    step's orders to run against (the monitor passes its last healthy
    host copy).  The live tensors are never written.  Never raises: a
    probe failure returns an ``"error"`` entry instead of masking the
    trip."""
    try:
        return _localize(net, loss_fn, x, y, params)
    except Exception as e:  # noqa: BLE001 - diagnostics must not mask the trip
        return {"error": repr(e), "first_fwd": None, "first_bwd": None}


def _as_tensor(v):
    if isinstance(v, (tuple, list)):
        return tuple(_as_tensor(a) for a in v)
    if isinstance(v, torch.Tensor):
        return v.detach()
    data = getattr(v, "_data", None)
    if isinstance(data, torch.Tensor):
        return data.detach()
    return torch.as_tensor(np.asarray(v))


def _nonfinite(o) -> int:
    if isinstance(o, torch.Tensor) and o.is_floating_point():
        return int(torch.sum(~torch.isfinite(o.detach())))
    data = getattr(o, "_data", None)
    return _nonfinite(data) if isinstance(data, torch.Tensor) else 0


def _localize(net, loss_fn, x, y, params=None) -> Dict[str, Any]:
    from ..cached_op import generators_of
    xs = _as_tensor(x)
    xs = xs if isinstance(xs, tuple) else (xs,)
    y_t = _as_tensor(y)
    dev = xs[0].device
    learn_names, aux_names = _tensor_parts(net)
    tensors = dict(net.named_parameters())
    tensors.update(net.named_buffers())
    live_learn = [tensors[n] for n in learn_names]
    if params is not None:
        learn_src, aux_src = params
    else:
        learn_src = live_learn
        aux_src = [tensors[n] for n in aux_names]
    # copies on the inputs' device: BatchNorm in training mode writes its
    # moving statistics into these, never into the live buffers
    learn = [t.detach().to(dev).clone().requires_grad_(True)
             for t in learn_src]
    bound = dict(zip(learn_names, learn))
    bound.update(zip(aux_names, [t.detach().to(dev).clone()
                                 for t in aux_src]))
    names = param_names(net, live_learn)
    blocks = _leaf_blocks(net)
    owner: Dict[int, List[str]] = {}
    by_id = {id(t): n for n, t in zip(names, live_learn)}
    for b in blocks:
        owner[id(b)] = [by_id[id(t)] for t in b.parameters(recurse=False)
                        if id(t) in by_id]
    fwd_rows: List[Tuple[str, int]] = []
    exec_order: List = []
    saved: List = []

    def probe_wrap(block):
        orig = block.forward

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            exec_order.append(block)
            outs = out if isinstance(out, (list, tuple)) else [out]
            fwd_rows.append((_block_name(block),
                             sum(_nonfinite(o) for o in outs)))
            return out

        _patch_forward(block, wrapped, saved)

    report: Dict[str, Any] = {"first_fwd": None, "first_bwd": None}
    gens = generators_of(net, dev)
    states = [g.get_state() for g in gens]
    was_training = net.training
    try:
        for b in blocks:
            probe_wrap(b)
        net.train()
        with torch.enable_grad():
            try:
                out = torch.func.functional_call(net, bound, xs)
            finally:
                _restore_forwards(saved)
            loss = loss_fn(out, y_t).mean()
            report["loss_nonfinite"] = _nonfinite(loss)
            grads = torch.autograd.grad(loss, learn, allow_unused=True)
    finally:
        net.train(was_training)
        for g, s in zip(gens, states):
            g.set_state(s)
    report["fwd"] = list(fwd_rows)
    for name, n in fwd_rows:
        if n:
            report["first_fwd"] = name
            break
    bad_params, bwd_rows = [], []
    for name, g in zip(names, grads):
        n = _nonfinite(g) if g is not None else 0
        bwd_rows.append((name, n))
        if n:
            bad_params.append(name)
    report["bwd"] = bwd_rows
    report["nonfinite_params"] = bad_params
    if bad_params:
        bad = set(bad_params)
        for b in reversed(exec_order):
            if bad & set(owner.get(id(b), ())):
                report["first_bwd"] = _block_name(b)
                break
        if report["first_bwd"] is None:  # params not owned by a probe
            report["first_bwd"] = bad_params[-1]
    return report


class _BwdInject(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``val`` (NaN/Inf)."""

    @staticmethod
    def forward(ctx, x, val):
        ctx.val = val
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.val, None


class NumericsFaultPlan:
    """Deterministic NaN/Inf injection at NAMED leaf blocks — the test
    oracle for localization.  ``plan`` maps leaf-block names to
    ``"fwd:nan"`` / ``"fwd:inf"`` / ``"bwd:nan"`` / ``"bwd:inf"``:

    * ``fwd`` multiplies the block's output by the constant;
    * ``bwd`` passes the output through an identity ``autograd.Function``
      whose backward scales the gradient by the constant: the forward
      value is untouched and the fault fires in every backward (the
      training step's, inside its graph, and the localization probe's).

    A step whose health is armed takes the patched forwards into its graph
    signature (:func:`hook_fingerprint`), so a plan entered after a
    capture is captured anew; enter it before the first step otherwise."""

    def __init__(self, net, plan: Dict[str, str]):
        self._net = net
        self._plan = dict(plan)
        self._saved: List[Tuple[Any, Callable, bool]] = []

    def __enter__(self) -> "NumericsFaultPlan":
        by_name = {_block_name(b): b for b in _leaf_blocks(self._net)}
        unknown = set(self._plan) - set(by_name)
        if unknown:
            raise ValueError(f"unknown layers {sorted(unknown)}; "
                             f"known: {sorted(by_name)}")
        for name, spec in self._plan.items():
            mode, _, kind = spec.partition(":")
            kind = kind or "nan"
            if mode not in ("fwd", "bwd") or kind not in ("nan", "inf"):
                raise ValueError(
                    f"bad injection spec {spec!r} for layer {name!r}; "
                    f"expected 'fwd|bwd:nan|inf'")
            val = float("nan") if kind == "nan" else float("inf")
            block = by_name[name]
            orig = block.forward

            def wrapped(*args, _orig=orig, _mode=mode, _val=val, **kw):
                out = _orig(*args, **kw)
                single = not isinstance(out, (list, tuple))
                outs = [out] if single else list(out)
                inj = []
                for o in outs:
                    if not (isinstance(o, torch.Tensor)
                            and o.is_floating_point()):
                        inj.append(o)
                    elif _mode == "fwd":
                        inj.append(o * _val)
                    else:
                        inj.append(_BwdInject.apply(o, _val))
                return inj[0] if single else type(out)(inj)

            _patch_forward(block, wrapped, self._saved)
        return self

    def __exit__(self, *exc):
        _restore_forwards(self._saved)
        return False


# ===========================================================================
# cross-rank divergence checksums
# ===========================================================================
def _digest(t) -> str:
    if isinstance(t, torch.Tensor):
        from ..checkpoint import _host_bytes
        data = _host_bytes(t)
    else:
        data = np.asarray(getattr(t, "_data", t))
        if isinstance(data, torch.Tensor):
            return _digest(data)
    return hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest()


def checksum_arrays(named: Dict[str, Any]) -> Dict[str, List[str]]:
    """Per-key sha256 digests of each tensor's bytes (one device per
    process in the port, so one digest per key)."""
    return {k: [_digest(raw)] for k, raw in named.items()}


def _fold(digests: Sequence[str]) -> str:
    return hashlib.sha256("".join(digests).encode()).hexdigest()


def divergence_report(named: Dict[str, Any],
                      buckets: Optional[List[List[str]]] = None,
                      cross_process: bool = True) -> Dict[str, Any]:
    """One divergence-checksum round over ``named`` (key -> tensor).

    Each key's digest is folded; ``buckets`` (lists of keys, the step's
    gradient-bucket layout) also fold member digests per bucket.  In a job
    of several processes every rank's folds are gathered on rank 0 over
    the process group (``profiler._allgather_blobs``, bounded by
    ``MXNET_KVSTORE_TIMEOUT``), and the minority digest names the
    diverging rank.  Every rank must join every round.  Returns
    ``{"agree", "diverging": [{"rank", "key", "scope"}...], "keys",
    "buckets", "nproc", ...}`` and feeds the checksum metrics and the
    ledger."""
    digests = checksum_arrays(named)
    diverging: List[Dict[str, Any]] = []
    rec: Dict[str, Any] = {
        "kind": "checksum", "t_unix": time.time(),
        "keys": {k: _fold(ds) for k, ds in digests.items()},
        "sharded": [], "diverging": diverging, "nproc": 1,
    }
    if buckets:
        rec["buckets"] = [
            _fold([_fold(digests[k]) for k in group if k in digests])
            for group in buckets]
    if cross_process:
        from .. import distributed, profiler
        from ..resilience import RankFailureError, call_with_timeout
        nproc = distributed.process_count()
        rec["nproc"] = nproc
        if nproc > 1:
            payload = json.dumps(rec["keys"], sort_keys=True).encode()
            blobs = call_with_timeout(
                lambda: profiler._allgather_blobs(payload),
                float(_env.MXNET_KVSTORE_TIMEOUT),
                f"health divergence-checksum exchange "
                f"({len(digests)} keys)",
                error=lambda m: RankFailureError(
                    m + "; a peer rank is dead or wedged — every rank "
                        "must join every checksum round"))
            if blobs is not None:  # rank 0 compares
                per_rank = [json.loads(b.decode()) for b in blobs]
                for k in rec["keys"]:
                    vals = [pr.get(k) for pr in per_rank]
                    if len(set(vals)) <= 1:
                        continue
                    counts: Dict[Any, int] = {}
                    for v in vals:
                        counts[v] = counts.get(v, 0) + 1
                    majority = max(counts, key=counts.get)
                    for r, v in enumerate(vals):
                        if v != majority:
                            diverging.append({"rank": r, "key": k,
                                              "scope": "process"})
    rec["agree"] = not diverging
    _M_CHECKSUM_ROUNDS.inc()
    if diverging:
        _M_CHECKSUM_MISMATCHES.inc()
    _LEDGER.record_checksum(rec)
    return rec


# ===========================================================================
# the training step's monitor
# ===========================================================================
def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class HealthMonitor:
    """Per-step watchpoint machinery: cadence-gated stat fetch, gauge
    export, sentinel trips (localization + response policy), spike
    detection and divergence-checksum rounds.  The training step calls
    :meth:`after_call` once per call; everything here runs on the host."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.loss_detector = SpikeDetector(self.config.window,
                                           self.config.zscore)
        self.grad_detector = SpikeDetector(self.config.window,
                                           self.config.zscore)
        # the last healthy (learnable, aux) host copy, for localization:
        # the tripping step has already written poisoned parameters
        self._healthy: Optional[Tuple[list, list]] = None
        self._healthy_step = -1
        # a trip episode localizes once; a healthy window re-arms it
        self._in_trip_episode = False

    def reconfigure(self, config: HealthConfig) -> None:
        """Swap the host-side knobs in place.  ``watchpoints`` decides what
        the step computes and cannot change."""
        if self.config.watchpoints != config.watchpoints:
            raise MXNetError(
                "watchpoints are part of the step's graph; a step cannot be "
                "reconfigured across that flag")
        if (config.window, config.zscore) != (self.config.window,
                                              self.config.zscore):
            self.loss_detector = SpikeDetector(config.window, config.zscore)
            self.grad_detector = SpikeDetector(config.window, config.zscore)
        self.config = config

    # ------------------------------------------------------------- skip
    def snapshot_for_skip(self, step) -> Optional[Dict[str, Any]]:
        """Under ``action='skip'``: a device copy of the step's world
        (parameters, the net's other tensors, optimizer-state tensors)
        and its counts, taken before the call; otherwise None.  The step
        updates every tensor in place, so skipping needs real copies."""
        if self.config.action != "skip":
            return None
        return step._world_copy()

    @staticmethod
    def _rows(stats_np, k_steps: int, stacked: bool):
        """Per-step rows: a stacked fetch (``MultiStepTrainStep``) has a
        leading K axis on every leaf, a single step's has none."""
        rows = []
        for i in range(k_steps):
            row = {}
            for key in ("grad_sq", "param_sq", "upd_sq", "grad_nonfinite",
                        "loss_nonfinite"):
                row[key] = stats_np[key][i] if stacked else stats_np[key]
            row["taps"] = {name: (v[i] if stacked else v)
                           for name, v in stats_np.get("taps", {}).items()}
            rows.append(row)
        return rows

    # ------------------------------------------------------------- main hook
    def after_call(self, step, stats, k_steps: int, prev_update: int,
                   x_raw, y_raw, loss_raw, pre_snap=None) -> Optional[str]:
        """Post-call health pass.  Returns ``"skip"`` when the response
        policy decided to drop the call (the step restores ``pre_snap``);
        otherwise None.  ``prev_update`` is the step count BEFORE this
        call, so the cadence is threshold-based."""
        cfg = self.config
        every = cfg.every
        now = prev_update + k_steps
        do_checksum = cfg.checksum_every > 0 and \
            (prev_update // cfg.checksum_every) != \
            (now // cfg.checksum_every)
        if (prev_update // every) == (now // every):
            if do_checksum:
                self.checksum_round(step)
            return None
        t0 = time.perf_counter()
        stacked = bool(getattr(step, "_stats_stacked", False))
        with _tracing.span("health.fetch", attrs={"step": now}) as _sp:
            stats_np = {k: _host(v) for k, v in stats.items() if k != "taps"}
            stats_np["taps"] = {n: _host(v)
                                for n, v in stats.get("taps", {}).items()}
            loss_np = _host(loss_raw).ravel()
        _M_FETCHES.inc()
        rows = self._rows(stats_np, k_steps, stacked)

        last = rows[-1]
        grad_norm = float(np.sqrt(np.sum(last["grad_sq"])))
        param_norm = float(np.sqrt(np.sum(last["param_sq"])))
        upd_norm = float(np.sqrt(np.sum(last["upd_sq"])))
        ratio = upd_norm / param_norm if param_norm > 0 else 0.0
        _M_GRAD_NORM.set(grad_norm)
        _M_PARAM_NORM.set(param_norm)
        _M_UPDATE_RATIO.set(ratio)
        names = step._names
        rec = {
            "kind": "watchpoint", "step": now, "t_unix": time.time(),
            "grad_norm": grad_norm, "param_norm": param_norm,
            "update_ratio": ratio,
            "loss": (float(loss_np[-1]) if loss_np.size else None),
            "per_param": {
                n: {"grad_sq": float(g), "nonfinite": int(nf)}
                for n, g, nf in zip(names, np.atleast_1d(last["grad_sq"]),
                                    np.atleast_1d(last["grad_nonfinite"]))},
            "taps": {n: float(np.asarray(v)) for n, v in
                     last.get("taps", {}).items()},
        }
        _LEDGER.record_step(rec)
        _M_FETCH_SECONDS.observe(time.perf_counter() - t0,
                                 exemplar={"trace_id": _sp.trace_id})

        # checksum round BEFORE trip handling: a rank-local trip must not
        # desync the round the other ranks are entering
        if do_checksum:
            self.checksum_round(step)

        nf_grads = int(sum(int(np.sum(r["grad_nonfinite"])) for r in rows))
        nf_loss = int(sum(int(np.sum(r["loss_nonfinite"])) for r in rows))
        if nf_grads or nf_loss:
            return self._trip(step, rows, names, nf_grads, nf_loss,
                              x_raw, y_raw, prev_update, stacked, pre_snap)

        for i, r in enumerate(rows):
            gn = float(np.sqrt(np.sum(r["grad_sq"])))
            lv = float(loss_np[i]) if i < loss_np.size else None
            for signal, det, v in (("grad_norm", self.grad_detector, gn),
                                   ("loss", self.loss_detector, lv)):
                if v is None or not det.update(v):
                    continue
                _M_SPIKES.labels(signal=signal).inc()
                srec = {"kind": "spike", "signal": signal, "value": v,
                        "step": prev_update + 1 + i, "t_unix": time.time()}
                _LEDGER.record_spike(srec)
                act = cfg.action if cfg.action != "skip" else "log"
                _respond(act, srec,
                         f"{signal} spike at step {srec['step']}: "
                         f"{v:.6g} beyond the rolling z={cfg.zscore:g} band",
                         where=signal)

        # healthy window: close the trip episode and refresh the
        # localization copy (on the host: a device copy would hold one more
        # set of parameters on the card for the whole run)
        self._in_trip_episode = False
        if cfg.localize:
            self._healthy = ([p.detach().to("cpu", copy=True)
                              for p in step._learnable],
                             [t.detach().to("cpu", copy=True)
                              for t in step._aux])
            self._healthy_step = now
        return None

    # ------------------------------------------------------------- trips
    def _trip(self, step, rows, names, nf_grads: int, nf_loss: int,
              x_raw, y_raw, prev_update: int, stacked: bool,
              pre_snap) -> Optional[str]:
        cfg = self.config
        if nf_grads:
            _M_NONFINITE.labels(where="grad").inc(nf_grads)
        if nf_loss:
            _M_NONFINITE.labels(where="loss").inc(nf_loss)
        bad_k = 0
        for i, r in enumerate(rows):
            if int(np.sum(r["grad_nonfinite"])) or \
                    int(np.sum(r["loss_nonfinite"])):
                bad_k = i
                break
        nf_vec = np.atleast_1d(rows[bad_k]["grad_nonfinite"])
        bad_params = [n for n, c in zip(names, nf_vec) if int(c)]
        bad_buckets = []
        if step._grad_buckets:
            bad_idx = {i for i, c in enumerate(nf_vec) if int(c)}
            bad_buckets = [bi for bi, idxs in enumerate(step._grad_buckets)
                           if bad_idx & set(idxs)]
        rec: Dict[str, Any] = {
            "kind": "nonfinite", "t_unix": time.time(),
            "step": prev_update + 1 + bad_k,
            "nonfinite_grads": nf_grads, "nonfinite_loss": nf_loss,
            "params": bad_params, "buckets": bad_buckets,
            "first_param": bad_params[-1] if bad_params else None,
        }
        first_of_episode = not self._in_trip_episode
        self._in_trip_episode = True
        if cfg.localize and not first_of_episode:
            rec["localization"] = {
                "suppressed": "repeat trip in the same episode; see the "
                              "episode's first trip for the probe report"}
        if cfg.localize and first_of_episode:
            def slice_k(v):
                if isinstance(v, tuple):
                    return tuple(slice_k(a) for a in v)
                return v[bad_k] if stacked else v

            t0 = time.perf_counter()
            loc = localize(step._net, step._loss_fn,
                           slice_k(x_raw), slice_k(y_raw),
                           params=self._healthy)
            loc["seconds"] = time.perf_counter() - t0
            loc["healthy_snapshot_step"] = (
                self._healthy_step if self._healthy is not None else None)
            rec["localization"] = loc
            rec["first_fwd"] = loc.get("first_fwd")
            rec["first_bwd"] = loc.get("first_bwd")
        _LEDGER.record_trip(rec)
        first = rec.get("first_fwd") or rec.get("first_bwd") \
            or rec.get("first_param") or "?"
        msg = (f"non-finite sentinel trip at step {rec['step']}: "
               f"{nf_grads} grad / {nf_loss} loss non-finite values; "
               f"first faulting layer/bucket: {first}"
               + (f" (buckets {bad_buckets})" if bad_buckets else ""))
        if cfg.action == "skip" and pre_snap is not None:
            from . import flight_recorder as _fr
            _fr.record_event("health.nonfinite", step=rec["step"],
                             first=first, action="skip")
            _log.warning("health: %s — skipping the step (pre-step state "
                         "restored)", msg)
            return "skip"
        _respond(cfg.action, rec, msg, where="grad" if nf_grads else "loss")
        return None

    # ------------------------------------------------------------- checksums
    def checksum_round(self, step) -> Dict[str, Any]:
        """One divergence round over the step's parameters, folded per the
        step's gradient-bucket layout (when fused)."""
        names = step._names
        named = dict(zip(names, step._learnable))
        buckets = None
        if step._grad_buckets:
            buckets = [[names[i] for i in idxs]
                       for idxs in step._grad_buckets]
        rec = divergence_report(named, buckets=buckets)
        if not rec["agree"]:
            div = rec["diverging"]
            keys = sorted({d["key"] for d in div})
            ranks = sorted({d["rank"] for d in div})
            rec2 = {"kind": "divergence", "t_unix": time.time(),
                    "diverging_rank": ranks[0], "ranks": ranks,
                    "keys": keys}
            act = self.config.action if self.config.action != "skip" \
                else "log"
            _respond(act, rec2,
                     f"divergence checksum mismatch: rank(s) {ranks} "
                     f"drifted on keys {keys[:8]}"
                     + ("..." if len(keys) > 8 else ""),
                     where="checksum")
        return rec


# ===========================================================================
# serving sentinel (decode-path non-finite logits)
# ===========================================================================
_serving_warned_tags: set = set()


def serving_sentinel_enabled() -> bool:
    return bool(_env.MXNET_TPU_HEALTH)


def check_logits(tag: str, arr, action: Optional[str] = None) -> None:
    """Decode-path sentinel over host logits ``arr``; gate the host copy
    with :func:`serving_sentinel_enabled` before calling.  ``action``
    defaults to ``MXNET_TPU_HEALTH_ACTION``."""
    a = np.asarray(arr)
    bad = int(a.size - np.isfinite(a).sum())
    if not bad:
        return
    _M_NONFINITE.labels(where="logits").inc(bad)
    rec = {"kind": "nonfinite_logits", "tag": tag, "count": bad,
           "t_unix": time.time()}
    _LEDGER.record_trip(rec)
    act = (action or str(_env.MXNET_TPU_HEALTH_ACTION)).strip().lower()
    if act == "skip":  # a training policy; degrades to log here
        act = "log"
    # the once-per-tag dedup fights log spam only: every raise raises and
    # every dump writes its post-mortem
    if act != "log" or tag not in _serving_warned_tags:
        _serving_warned_tags.add(tag)
        _respond(act, rec,
                 f"non-finite logits ({bad} values) on the {tag} path")
