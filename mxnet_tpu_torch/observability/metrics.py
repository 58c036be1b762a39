"""Dimensional metrics registry with Prometheus text exposition.

Counterpart of ``mxnet_tpu/observability/metrics.py``: typed
:class:`Counter` / :class:`Gauge` / :class:`Histogram` families with label
dimensions in one process-global :class:`MetricsRegistry`, rendered as
Prometheus text exposition format 0.0.4 (``ModelServer`` serves it at
``GET /metrics``) or as OpenMetrics with exemplars.  Family names are the
JAX package's, so the same dashboards read both.

Naming convention (enforced at declaration time and by
``tests/test_torch_telemetry_lint.py``)::

    mxnet_tpu_<subsystem>_<name>[_unit]

* counters end in ``_total``;
* histograms end in a base unit (``_seconds``, ``_bytes``, ``_rows``);
* all segments are lowercase ``[a-z0-9]``.

:class:`Baselined` scopes a process-global monotonic series to one
object's lifetime (what ``ServingStats`` uses so a fresh server starts its
section at zero while ``/metrics`` stays cumulative, as Prometheus
requires).  :func:`aggregate_all` merges every rank's snapshot over
``torch.distributed`` when a process group is up.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "render_prometheus", "snapshot", "aggregate_all", "Baselined",
    "exponential_buckets", "METRIC_NAME_RE",
]

# mxnet_tpu_<subsystem>_<name>[_unit] — at least two segments after the
# mxnet_tpu_ prefix, all lowercase alnum
METRIC_NAME_RE = re.compile(r"^mxnet_tpu_[a-z0-9]+(?:_[a-z0-9]+)+$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")


def exponential_buckets(start: float = 1e-4, factor: float = 2.0,
                        count: int = 18) -> Tuple[float, ...]:
    """Exponential bucket bounds (default: 100µs doubling to ~13s) — the
    latency ladder every duration histogram shares unless overridden."""
    out, b = [], float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    f = float(v)
    # the exposition format spells non-finite samples NaN/+Inf/-Inf — a
    # health gauge legitimately goes NaN when the tracked value does
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


class _Child:
    """One (metric family, label values) time series."""

    __slots__ = ("_lock", "_value", "_fn", "_sum", "_counts")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        if buckets is not None:
            self._sum = 0.0
            self._counts = [0] * (len(buckets) + 1)  # +1 for +Inf

    # counter/gauge surface ------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Collect-time callback (live gauges: queue depth, breaker state)."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class _HistChild(_Child):
    __slots__ = ("_buckets", "_exemplars")

    def __init__(self, buckets: Tuple[float, ...]):
        super().__init__(buckets=buckets)
        self._buckets = buckets
        # most recent (labels, value, unix_ts) observed in each bucket —
        # the OpenMetrics exemplar: "which trace last crossed this bucket"
        # (the Tail-at-Scale link from a histogram tail to its cause)
        self._exemplars: List[Optional[Tuple[Dict[str, Any], float, float]]] \
            = [None] * (len(buckets) + 1)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, Any]] = None) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                i = len(self._buckets)
                self._counts[-1] += 1
            if exemplar is not None:
                self._exemplars[i] = (dict(exemplar), v, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with (+Inf, total)."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self._buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((math.inf, acc + self._counts[-1]))
            return out

    def exemplars(self) -> List[Tuple[float, Optional[Tuple]]]:
        """``[(le, exemplar_or_None), ...]`` aligned with :meth:`cumulative`
        (exemplar = ``(labels, value, unix_ts)``)."""
        with self._lock:
            les = list(self._buckets) + [math.inf]
            return list(zip(les, list(self._exemplars)))

    def quantile_bucket_index(self, q: float) -> Optional[int]:
        """Index (into :meth:`cumulative`/:meth:`exemplars` order) of the
        bucket containing quantile ``q``; None when empty.  The ONE
        quantile-bucket scan — retention thresholds and tail-exemplar
        lookups must agree on the boundary, so both derive from here."""
        with self._lock:
            total = sum(self._counts)
            if total == 0:
                return None
            target = q * total
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= target:
                    return i
            return len(self._counts) - 1

    def quantile_lower(self, q: float) -> float:
        """LOWER edge of the bucket containing quantile ``q`` (0 when the
        histogram is empty or q falls in the first bucket).  Every observed
        value >= this edge is in the quantile's bucket or above — the
        retention threshold that is guaranteed to cover the bucket whose
        exemplar answers "what was the p99"."""
        i = self.quantile_bucket_index(q)
        if i is None or i == 0:
            return 0.0
        return float(self._buckets[min(i - 1, len(self._buckets) - 1)])


class _Metric:
    """A metric family: one name, one kind, N labeled children."""

    kind = "untyped"

    def __init__(self, name: str, doc: str, labels: Sequence[str] = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        if not METRIC_NAME_RE.match(name):
            raise MXNetError(
                f"metric name {name!r} violates the "
                "mxnet_tpu_<subsystem>_<name>[_unit] convention")
        for l in labels:
            if not _LABEL_RE.match(l):
                raise MXNetError(f"invalid label name {l!r} on {name}")
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labels)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self) -> _Child:
        return _Child()

    def labels(self, **kv) -> _Child:
        """The child series for these label values (created on first use)."""
        if set(kv) != set(self.labelnames):
            raise MXNetError(
                f"{self.name}: labels() expects {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[l]) for l in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _series(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{l}="{_escape_label(v)}"'
                 for l, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    # unlabeled convenience (delegates to the default child) ---------------
    def _one(self) -> _Child:
        if self._default is None:
            raise MXNetError(f"{self.name} is labeled {self.labelnames}; "
                             "use .labels(...)")
        return self._default

    def _reset_values(self) -> None:
        """Zero every child (test isolation; not part of the scrape surface)."""
        with self._lock:
            children = list(self._children.values())
        for c in children:
            with c._lock:
                c._value = 0.0
                if hasattr(c, "_sum"):
                    c._sum = 0.0
                    c._counts = [0] * len(c._counts)
                if hasattr(c, "_exemplars"):
                    c._exemplars = [None] * len(c._exemplars)

    def _family_name(self, openmetrics: bool) -> str:
        # OpenMetrics names a counter FAMILY without the _total suffix
        # (samples keep it); the classic 0.0.4 format uses the full name.
        if openmetrics and self.kind == "counter" \
                and self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name

    def render(self, exemplars: bool = False,
               openmetrics: bool = False) -> List[str]:
        fam = self._family_name(openmetrics)
        lines = [f"# HELP {fam} {self.doc or self.name}",
                 f"# TYPE {fam} {self.kind}"]
        for key, child in self._series():
            lines.append(f"{self.name}{self._label_str(key)} "
                         f"{_fmt(child.value)}")
        return lines

    def sample_dict(self) -> Dict[str, Any]:
        return {self._label_str(k) or "": c.value for k, c in self._series()}


class Counter(_Metric):
    """Monotonic count; name must end in ``_total``."""

    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._one().inc(amount)

    @property
    def value(self) -> float:
        return self._one().value


class Gauge(_Metric):
    """Point-in-time value; settable or backed by a collect-time callback."""

    kind = "gauge"

    def set(self, value: float) -> None:
        self._one().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._one().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._one().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._one().set_function(fn)

    @property
    def value(self) -> float:
        return self._one().value


class Histogram(_Metric):
    """Exponential-bucket distribution (latencies, sizes)."""

    kind = "histogram"

    def __init__(self, name: str, doc: str, labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        b = tuple(sorted(buckets)) if buckets else exponential_buckets()
        super().__init__(name, doc, labels, buckets=b)

    def _make_child(self) -> _HistChild:
        return _HistChild(self._buckets)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, Any]] = None) -> None:
        self._one().observe(value, exemplar=exemplar)

    @property
    def count(self) -> int:
        return self._one().count

    @property
    def sum(self) -> float:
        return self._one().sum

    def render(self, exemplars: bool = False,
               openmetrics: bool = False) -> List[str]:
        lines = [f"# HELP {self.name} {self.doc or self.name}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in self._series():
            ex = (dict(enumerate(e for _, e in child.exemplars()))
                  if exemplars else {})
            for i, (le, acc) in enumerate(child.cumulative()):
                le_pair = 'le="%s"' % _fmt(le)
                line = (f"{self.name}_bucket"
                        f"{self._label_str(key, le_pair)} {acc}")
                if ex.get(i) is not None:
                    # OpenMetrics exemplar syntax: the most recent
                    # observation that landed in THIS bucket, carrying the
                    # trace that produced it (tail attribution)
                    labels, v, ts = ex[i]
                    pairs = ",".join(f'{k}="{_escape_label(val)}"'
                                     for k, val in sorted(labels.items()))
                    line += f" # {{{pairs}}} {_fmt(v)} {ts:.3f}"
                lines.append(line)
            lines.append(f"{self.name}_sum{self._label_str(key)} "
                         f"{_fmt(child.sum)}")
            lines.append(f"{self.name}_count{self._label_str(key)} "
                         f"{child.count}")
        return lines

    def sample_dict(self) -> Dict[str, Any]:
        return {self._label_str(k) or "": {"sum": c.sum, "count": c.count}
                for k, c in self._series()}


class MetricsRegistry:
    """Process-global family store: declare-once, get-or-create semantics
    (safe to re-import a subsystem), walkable by the lint test."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _declare(self, cls, name: str, doc: str, labels=(), **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labels):
                    raise MXNetError(
                        f"metric {name!r} re-declared with different "
                        f"kind/labels ({m.kind}{m.labelnames} vs "
                        f"{cls.kind}{tuple(labels)})")
                want = kw.get("buckets")
                if want is not None and tuple(sorted(want)) != m._buckets:
                    # silently handing back the first family would drop the
                    # caller's intended resolution with no signal
                    raise MXNetError(
                        f"histogram {name!r} re-declared with different "
                        f"buckets ({m._buckets} vs {tuple(sorted(want))})")
                return m
            if cls is Counter and not name.endswith("_total"):
                raise MXNetError(
                    f"counter {name!r} must end in _total (naming convention)")
            m = cls(name, doc, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, doc: str = "", labels=()) -> Counter:
        return self._declare(Counter, name, doc, labels)

    def gauge(self, name: str, doc: str = "", labels=()) -> Gauge:
        return self._declare(Gauge, name, doc, labels)

    def histogram(self, name: str, doc: str = "", labels=(), buckets=None,
                  bucket_start: Optional[float] = None,
                  bucket_factor: Optional[float] = None,
                  bucket_count: Optional[int] = None) -> Histogram:
        """Declare a histogram.  ``buckets`` gives explicit bounds; or pass
        ``bucket_start``/``bucket_factor``/``bucket_count`` to build an
        exponential ladder at declare time — the knob that lets a µs-scale
        warm-path histogram resolve below the shared 100µs default floor."""
        if buckets is None and (bucket_start is not None
                                or bucket_factor is not None
                                or bucket_count is not None):
            buckets = exponential_buckets(
                start=1e-4 if bucket_start is None else float(bucket_start),
                factor=2.0 if bucket_factor is None else float(bucket_factor),
                count=18 if bucket_count is None else int(bucket_count))
        return self._declare(Histogram, name, doc, labels, buckets=buckets)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self, exemplars: bool = False,
               openmetrics: Optional[bool] = None) -> str:
        """Prometheus text exposition.  ``exemplars=True`` appends the
        OpenMetrics exemplar suffix to histogram bucket lines — only legal
        when served as application/openmetrics-text, so ``openmetrics``
        (defaulting to follow ``exemplars``) also switches counter FAMILY
        names to the OpenMetrics convention (`# TYPE x counter` with
        samples `x_total`); the classic text/plain 0.0.4 format must stay
        exemplar-free or standard scrapers reject the whole exposition."""
        if openmetrics is None:
            openmetrics = exemplars
        lines: List[str] = []
        for m in self.collect():
            lines.extend(m.render(exemplars=exemplars,
                                  openmetrics=openmetrics))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Structured machine-readable dump: ``{family: {kind, samples}}``
        (what the flight recorder embeds and :func:`aggregate_all` merges)."""
        return {m.name: {"kind": m.kind, "samples": m.sample_dict()}
                for m in self.collect()}

    def _reset_values(self) -> None:
        for m in self.collect():
            m._reset_values()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem declares into."""
    return _REGISTRY


def render_prometheus(exemplars: bool = False) -> str:
    return _REGISTRY.render(exemplars=exemplars)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


class Baselined:
    """Instance-scoped view over a process-global monotonic series — the
    generic bridge that lets legacy per-object stats (``ServingStats``)
    read registry-backed metrics while their sections keep starting at
    zero per object.  ``inc``/``observe`` write through; ``value`` is the
    delta since construction (or the last :meth:`rebase`)."""

    __slots__ = ("_child", "_base")

    def __init__(self, child: _Child):
        self._child = child
        self._base = child.value

    def inc(self, amount: float = 1.0) -> None:
        self._child.inc(amount)

    def observe(self, value: float) -> None:
        self._child.observe(value)

    @property
    def value(self) -> float:
        return self._child.value - self._base

    def rebase(self) -> None:
        self._base = self._child.value


def aggregate_all() -> Optional[Dict[str, Any]]:
    """Whole-job metric snapshot over ``torch.distributed`` (every rank
    must call it when a process group is up).  Rank 0 returns
    ``{"ranks": n, "metrics": merged}`` where counter and histogram samples
    are summed across ranks and gauge samples gain a ``rank`` label; other
    ranks return None.  Without a process group: the local snapshot under
    ``ranks: 1``."""
    from .. import profiler

    local = _REGISTRY.snapshot()
    blobs = profiler._allgather_blobs(json.dumps(local).encode())
    if blobs is None:
        return None
    if len(blobs) == 1:
        return {"ranks": 1, "metrics": local}
    merged: Dict[str, Dict[str, Any]] = {}
    for rank, blob in enumerate(blobs):
        snap = json.loads(blob.decode())
        for fam, body in snap.items():
            dst = merged.setdefault(fam, {"kind": body["kind"], "samples": {}})
            for key, val in body["samples"].items():
                if body["kind"] == "gauge":
                    # point-in-time values don't sum; keep per-rank series
                    rkey = (key[:-1] + f',rank="{rank}"}}' if key
                            else f'{{rank="{rank}"}}')
                    dst["samples"][rkey] = val
                elif isinstance(val, dict):  # histogram sum/count
                    cur = dst["samples"].setdefault(key,
                                                    {"sum": 0.0, "count": 0})
                    cur["sum"] += val["sum"]
                    cur["count"] += val["count"]
                else:
                    dst["samples"][key] = dst["samples"].get(key, 0) + val
    return {"ranks": len(blobs), "metrics": merged}
