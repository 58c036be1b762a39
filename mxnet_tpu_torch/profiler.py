"""Profiler: chrome-trace JSON, per-op aggregate stats, device traces.

Counterpart of ``mxnet_tpu/profiler.py`` (reference ``python/mxnet/
profiler.py``: set_config:33, set_state:89, dump:122, dumps:151,
Frame/Task/Counter/Marker scopes).  Two layers:

* **framework events** (host-side op dispatch through ``nd`` invoke,
  markers, scopes, tracing spans) recorded by a hook into an in-memory
  list, dumped as chrome-trace JSON (Perfetto / chrome://tracing);
* **device timeline**: with ``profile_device=True``, ``set_state('run')``
  starts ``torch.profiler`` with the CUDA activity (where the JAX package
  starts ``jax.profiler``), and ``set_state('stop')`` writes its chrome
  trace into ``device_trace_dir``.

``dumps()`` groups events by name (count/total/min/max/avg ms, the
reference's aggregate table) and appends one section per registered stats
provider (serving models, resilience).  ``dump_all()`` merges every
rank's events over ``torch.distributed`` when a process group is up.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .ndarray import ndarray as _nd_mod

__all__ = ["set_config", "set_state", "state", "dump", "dump_all", "dumps",
           "collecting",
           "pause", "resume", "Scope", "Marker", "scope", "marker",
           "Domain", "Task", "Frame", "Event", "Counter",
           "set_kvstore_handle", "profiler_set_config", "profiler_set_state",
           "dump_profile", "register_stats_provider",
           "unregister_stats_provider"]

_lock = threading.Lock()
_config = {
    "filename": "profile.json",
    "aggregate_stats": True,
    "profile_imperative": True,
    "profile_symbolic": True,
    "profile_api": True,
    "profile_memory": False,
    "profile_device": False,
    "device_trace_dir": "device_trace",
}
_state = {"running": False, "paused": False, "device_tracing": False}
_device_prof = [None]   # the running torch.profiler.profile, if any
_events: List[Dict[str, Any]] = []
_t_origin = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _t_origin) * 1e6


def collecting() -> bool:
    """True while events are recorded (running and not paused): the gate
    tracing spans consult before emitting into the chrome stream."""
    return _state["running"] and not _state["paused"]


def _append_event(ev: Dict[str, Any]) -> None:
    """The one write path into the event list, under ``_lock`` (an
    unlocked append would race ``dump()``'s clear)."""
    with _lock:
        _events.append(ev)


def set_config(**kwargs):
    """Configure the profiler (reference profiler.py:33).  Unknown
    ``profile_*`` switches are accepted and ignored."""
    for k, v in kwargs.items():
        if k in _config:
            _config[k] = v
        elif not k.startswith(("profile_", "continuous_", "aggregate_")):
            raise ValueError(f"unknown profiler config key {k!r}")


def state() -> str:
    return "run" if _state["running"] else "stop"


def set_state(state_name: str = "stop"):
    """Start/stop collection (reference profiler.py:89)."""
    if state_name not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop'")
    run = state_name == "run"
    if run and not _state["running"]:
        _state["running"] = True
        _install_hook()
        if _config["profile_device"]:
            _start_device_trace()
    elif not run and _state["running"]:
        _state["running"] = False
        _nd_mod._PROFILE_HOOK = None
        if _state["device_tracing"]:
            _stop_device_trace()


def pause():
    _state["paused"] = True
    _nd_mod._PROFILE_HOOK = None


def resume():
    _state["paused"] = False
    if _state["running"]:
        _install_hook()


def _install_hook():
    if _config["profile_imperative"]:
        _nd_mod._PROFILE_HOOK = _record_op_event


def _record_op_event(name: str, t0: float, t1: float):
    _append_event({
        "name": name, "cat": "operator", "ph": "X",
        "ts": (t0 - _t_origin) * 1e6, "dur": (t1 - t0) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident(),
    })


def _start_device_trace():
    """``torch.profiler`` over the CPU and, when a card is present, the
    CUDA activity (kernels, graph replays' kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:  # noqa: BLE001 - no device trace, host events go on
        _state["device_tracing"] = False
        return
    _device_prof[0] = prof
    _state["device_tracing"] = True


def _stop_device_trace():
    prof, _device_prof[0] = _device_prof[0], None
    try:
        if prof is not None:
            prof.__exit__(None, None, None)
            out = _config["device_trace_dir"]
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                out, f"device-{os.getpid()}.json"))
    finally:
        _state["device_tracing"] = False


# ---------------------------------------------------------------------------
# user scopes/markers (reference Frame/Task/Marker)
# ---------------------------------------------------------------------------
class Scope:
    """``with profiler.Scope("data-load"):`` duration event."""

    def __init__(self, name: str, category: str = "user"):
        self.name, self.category = name, category

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if collecting():
            _append_event({
                "name": self.name, "cat": self.category, "ph": "X",
                "ts": (self._t0 - _t_origin) * 1e6,
                "dur": (time.perf_counter() - self._t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
            })


def scope(name: str, category: str = "user") -> Scope:
    return Scope(name, category)


class Marker:
    """Instant event (reference ProfileMarker)."""

    def __init__(self, name: str, category: str = "user"):
        self.name, self.category = name, category

    def mark(self, scope_name: str = "process"):
        if collecting():
            _append_event({
                "name": self.name, "cat": self.category, "ph": "i",
                "ts": _now_us(), "s": "p" if scope_name == "process" else "t",
                "pid": os.getpid(), "tid": threading.get_ident(),
            })


def marker(name: str, category: str = "user") -> Marker:
    return Marker(name, category)


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------
def dump(finished: bool = True, profile_process: str = "worker"):
    """Write accumulated events as chrome-trace JSON to ``filename``
    (reference profiler.py:122).  Snapshot under the lock, serialize
    outside it."""
    with _lock:
        snapshot = list(_events)
        if finished:
            _events.clear()
    payload = {"traceEvents": snapshot, "displayTimeUnit": "ms"}
    with open(_config["filename"], "w") as f:
        json.dump(payload, f)


def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _allgather_blobs(payload: bytes) -> Optional[List[bytes]]:
    """All-gather one byte blob per rank over ``torch.distributed`` (the
    path ``dump_all()`` and ``observability.metrics.aggregate_all`` share).
    Collective: every rank must call it.  The per-rank list on rank 0,
    None on the others; ``[payload]`` without a process group."""
    if not _group_up():
        return [payload]
    import torch.distributed as dist
    got: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(got, payload)
    return got if dist.get_rank() == 0 else None


def dump_all(filename: Optional[str] = None) -> Optional[str]:
    """Whole-job profile: every rank sends its events over the process
    group and rank 0 writes one merged chrome trace with a lane per rank
    (timestamps shifted onto rank 0's wall clock).  Without a process
    group: ``dump()`` with pid 0.  Returns the path on rank 0, None
    elsewhere.  Collective: every rank must call it."""
    with _lock:
        local = [dict(ev) for ev in _events]
    anchor_us = time.time() * 1e6 - (time.perf_counter() - _t_origin) * 1e6
    path = filename or _config["filename"]
    if not _group_up():
        for ev in local:
            ev["pid"] = 0
        with open(path, "w") as f:
            json.dump({"traceEvents": local, "displayTimeUnit": "ms"}, f)
        return path
    payload = json.dumps({"anchor_us": anchor_us, "events": local}).encode()
    per_rank = _allgather_blobs(payload)
    if per_rank is None:
        return None
    merged = []
    anchor0 = None
    for r, raw in enumerate(per_rank):
        blob = json.loads(raw.decode())
        if anchor0 is None:
            anchor0 = blob["anchor_us"]
        shift = blob["anchor_us"] - anchor0
        for ev in blob["events"]:
            ev["pid"] = r
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift
        merged.extend(blob["events"])
    with open(path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    return path


# ---------------------------------------------------------------------------
# pluggable aggregate-stats providers: a subsystem registers a callable
# returning a flat dict; ``dumps()`` renders one section per provider
# ---------------------------------------------------------------------------
_STATS_PROVIDERS: Dict[str, Any] = {}


def register_stats_provider(name: str, fn) -> None:
    """Register ``fn() -> dict`` as a named section of ``dumps()``;
    re-registering a name replaces the provider."""
    if not callable(fn):
        raise ValueError("stats provider must be callable")
    _STATS_PROVIDERS[name] = fn


def unregister_stats_provider(name: str) -> None:
    _STATS_PROVIDERS.pop(name, None)


def _provider_snapshots() -> Dict[str, Dict[str, Any]]:
    """Every provider's snapshot; one that raises or returns a non-dict
    becomes ``{"error": repr}``, an empty one is left out."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(_STATS_PROVIDERS):
        try:
            snap = _STATS_PROVIDERS[name]()
            if not snap:
                continue
            if not isinstance(snap, dict):
                raise TypeError(f"provider returned {type(snap).__name__}, "
                                "expected dict")
            out[name] = snap
        except Exception as e:  # noqa: BLE001 - degradation by design
            out[name] = {"error": repr(e)}
    return out


def _provider_sections() -> List[str]:
    lines: List[str] = []
    for name, snap in _provider_snapshots().items():
        try:
            entry = [f"{str(k):<40}{snap[k]}" for k in sorted(snap, key=str)]
        except Exception as e:  # noqa: BLE001
            entry = [f"{'error':<40}{e!r}"]
        lines.append("")
        lines.append(f"[{name}]")
        lines.extend(entry)
    return lines


def dumps(reset: bool = False, format: str = "table"):
    """Aggregate per-op stats (reference profiler.py:151).  ``"table"``
    gives the text table with one ``[name]`` section per stats provider;
    ``"json"`` gives ``{"ops": {...}, "sections": {...}}``.  Tracing spans
    stay out of the op table (their durations nest)."""
    if format not in ("table", "json"):
        raise ValueError(f"dumps() format must be 'table' or 'json', "
                         f"got {format!r}")
    with _lock:
        agg: Dict[str, List[float]] = {}
        for ev in _events:
            if ev.get("ph") != "X" or ev.get("cat") == "span":
                continue
            dur_ms = ev["dur"] / 1e3
            row = agg.setdefault(ev["name"], [0, 0.0, float("inf"), 0.0])
            row[0] += 1
            row[1] += dur_ms
            row[2] = min(row[2], dur_ms)
            row[3] = max(row[3], dur_ms)
        if reset:
            _events.clear()
    if format == "json":
        ops = {name: {"count": int(cnt), "total_ms": tot, "min_ms": mn,
                      "max_ms": mx, "avg_ms": tot / cnt}
               for name, (cnt, tot, mn, mx) in agg.items()}
        return {"ops": ops, "sections": _provider_snapshots()}
    lines = [f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Avg(ms)':>10}"]
    for name in sorted(agg, key=lambda n: -agg[n][1]):
        cnt, tot, mn, mx = agg[name]
        lines.append(f"{name:<40}{cnt:>8}{tot:>12.3f}{mn:>10.3f}{mx:>10.3f}"
                     f"{tot / cnt:>10.3f}")
    lines.extend(_provider_sections())
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# scoped profiling objects (reference profiler.py:225-500)
# ---------------------------------------------------------------------------
class Domain:
    """Category grouping for tasks/frames/counters (chrome-trace 'cat')."""

    def __init__(self, name: str):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(name, category=self.name)


class _Range:
    """start()/stop() duration event; also a context manager."""

    _cat = "range"

    def __init__(self, domain, name: str):
        self._domain = getattr(domain, "name", str(domain)) if domain else ""
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = _now_us()

    def stop(self):
        if self._t0 is None:
            return
        if not collecting():
            self._t0 = None
            return
        _append_event({"name": self.name, "cat": self._domain or self._cat,
                       "ph": "X", "ts": self._t0,
                       "dur": _now_us() - self._t0, "pid": os.getpid(),
                       "tid": threading.get_ident()})
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __str__(self):
        return self.name


class Task(_Range):
    """Overlappable named range owned by a domain (reference Task)."""

    _cat = "task"


class Frame(_Range):
    """Repeating frame range, e.g. one training iteration (reference Frame)."""

    _cat = "frame"


class Event(_Range):
    """Process-wide event range (reference Event)."""

    _cat = "event"

    def __init__(self, name: str):
        super().__init__(None, name)


class Counter:
    """Named integer counter series (reference Counter)."""

    def __init__(self, domain, name: str, value=None):
        self._domain = getattr(domain, "name", str(domain))
        self.name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def _emit(self):
        if not collecting():
            return
        _append_event({"name": self.name, "cat": self._domain, "ph": "C",
                       "ts": _now_us(), "pid": os.getpid(),
                       "tid": threading.get_ident(),
                       "args": {self.name: self._value}})

    def set_value(self, value):
        self._value = value
        self._emit()

    def increment(self, delta=1):
        self._value += delta
        self._emit()

    def decrement(self, delta=1):
        self._value -= delta
        self._emit()

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self

    def __str__(self):
        return self.name


def set_kvstore_handle(handle=None):
    """Compat no-op (``dump_all()`` already gathers every rank)."""


# deprecated reference names (profiler.py:516-540)
def profiler_set_config(mode="symbolic", filename="profile.json"):
    set_config(profile_symbolic=mode in ("symbolic", "all"),
               filename=filename)


def profiler_set_state(state="stop"):
    set_state(state)


def dump_profile():
    dump(True)
