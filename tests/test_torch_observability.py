"""Port parity: ``mxnet_tpu_torch.observability`` (metrics, tracing, flight
recorder) and ``profiler`` against the JAX package's, on the CPU.

Fresh registries in both packages, given the same declarations and
observations (and one frozen wall clock for exemplar timestamps), must
render byte-equal Prometheus 0.0.4 and OpenMetrics text and equal
snapshots.  Span trees, cross-thread parents, chrome flow events, tail
retention and the flight ring are compared as structures (names and
parent links; ids and times differ between processes' counters by
design).
"""
import threading
import time
import types

import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu.observability import (flight_recorder as jflight,
                                     metrics as jmetrics, tracing as jtrace)

from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import (flight_recorder as tflight,
                                           metrics as tmetrics,
                                           tracing as ttrace)

METRICS = {"jax": jmetrics, "torch": tmetrics}
TRACING = {"jax": jtrace, "torch": ttrace}
PROF = {"jax": jprof, "torch": tprof}


def _populate(m):
    """The same declarations and observations on a fresh registry."""
    reg = m.MetricsRegistry()
    c = reg.counter("mxnet_tpu_serving_requests_total", "Requests done.",
                    labels=("model",))
    c.labels(model="bert").inc()
    c.labels(model="bert").inc(2)
    c.labels(model='we"ird\\name').inc(0.5)
    g = reg.gauge("mxnet_tpu_serving_queue_depth", "Queue depth.")
    g.set(7)
    g.dec(2)
    nan = reg.gauge("mxnet_tpu_health_grad_norm", "A NaN gauge.")
    nan.set(float("nan"))
    live = reg.gauge("mxnet_tpu_memory_live_bytes", "Live bytes.",
                     labels=("component",))
    live.labels(component="serving:kv_pages:llama").set_function(
        lambda: 4096.0)
    h = reg.histogram("mxnet_tpu_serving_request_latency_seconds",
                      "Latency.", labels=("model",), bucket_start=1e-5,
                      bucket_factor=2.0, bucket_count=24)
    for i, v in enumerate((3e-6, 2.5e-4, 0.004, 0.004, 1.5, 200.0)):
        h.labels(model="bert").observe(v, exemplar={"trace_id": 100 + i})
    h.labels(model="llama").observe(0.02)
    plain = reg.histogram("mxnet_tpu_executor_step_seconds", "Steps.")
    plain.observe(0.3)
    reg.counter("mxnet_tpu_resilience_retries_total", "Retries.").inc(3)
    return reg


@pytest.fixture
def frozen_clock(monkeypatch):
    fake = types.SimpleNamespace(time=lambda: 1_700_000_000.25,
                                 perf_counter=time.perf_counter,
                                 monotonic=time.monotonic)
    for m in METRICS.values():
        monkeypatch.setattr(m, "time", fake)


@pytest.mark.parametrize("exemplars,openmetrics", [
    (False, None), (True, None), (False, True), (True, False)])
def test_fresh_registries_render_byte_equal(frozen_clock, exemplars,
                                            openmetrics):
    text = {k: _populate(m).render(exemplars=exemplars,
                                   openmetrics=openmetrics)
            for k, m in METRICS.items()}
    assert text["torch"] == text["jax"]
    assert "mxnet_tpu_serving_requests_total" in text["torch"]
    if exemplars:
        assert ' # {trace_id="105"} 200 1700000000.250' in text["torch"]
    else:
        assert " # {" not in text["torch"]


def test_snapshots_quantiles_and_baselined_match(frozen_clock):
    out = {}
    for k, m in METRICS.items():
        reg = _populate(m)
        hist = reg.get("mxnet_tpu_serving_request_latency_seconds")
        child = hist.labels(model="bert")
        b = m.Baselined(reg.get("mxnet_tpu_resilience_retries_total")._one())
        b.inc(2)
        v1 = b.value
        b.rebase()
        # repr: the NaN gauge compares equal only as text
        out[k] = repr((reg.snapshot(), child.quantile_bucket_index(0.5),
                       child.quantile_lower(0.99), child.cumulative(),
                       child.exemplars(), v1, b.value,
                       m.exponential_buckets(1e-6, 4.0, 14)))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("bad", [
    ("counter", "mxnet_tpu_serving_requests", ()),       # no _total
    ("gauge", "serving_queue_depth", ()),                # no prefix
    ("gauge", "mxnet_tpu_Serving_depth", ()),            # upper case
    ("counter", "mxnet_tpu_x_y_total", ("Bad-Label",)),  # label name
])
def test_naming_contract_enforced_alike(bad):
    kind, name, labels = bad
    raised = {}
    for k, m in METRICS.items():
        reg = m.MetricsRegistry()
        try:
            getattr(reg, kind)(name, "doc", labels=labels)
            raised[k] = None
        except Exception as e:  # noqa: BLE001 - the outcome
            raised[k] = type(e).__name__
    assert raised["torch"] == raised["jax"] == "MXNetError"


def test_redeclaration_rules_alike():
    out = {}
    for k, m in METRICS.items():
        reg = m.MetricsRegistry()
        a = reg.counter("mxnet_tpu_x_y_total", "d", labels=("model",))
        same = reg.counter("mxnet_tpu_x_y_total", "d", labels=("model",)) is a
        errs = []
        for call in (lambda: reg.gauge("mxnet_tpu_x_y_total"),
                     lambda: reg.counter("mxnet_tpu_x_y_total",
                                         labels=("other",)),
                     lambda: a.labels(wrong="1"), lambda: a.inc()):
            try:
                call()
                errs.append(None)
            except Exception as e:  # noqa: BLE001
                errs.append(type(e).__name__)
        h = reg.histogram("mxnet_tpu_x_z_seconds", buckets=(1.0, 2.0))
        try:
            reg.histogram("mxnet_tpu_x_z_seconds", buckets=(1.0, 3.0))
            errs.append(None)
        except Exception as e:  # noqa: BLE001
            errs.append(type(e).__name__)
        out[k] = (same, errs, h._buckets)
    assert out["torch"] == out["jax"]
    with pytest.raises(MXNetError):
        tmetrics.MetricsRegistry().counter("bad_name_total")


# ----------------------------------------------------------------- tracing
def _shape(spans, root_id):
    """A span set as {(name, parent name or None, on the root's thread)}."""
    by_id = {s["span_id"]: s for s in spans}
    root_tid = by_id[root_id]["tid"]
    return sorted((s["name"],
                   by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id
                   else None, s["tid"] == root_tid) for s in spans)


def _traced_request(tr):
    """One request's span tree: a root, a nested child, an explicit-parent
    span on another thread (with its own nested child), and a span
    started without a parent on that thread (a new trace)."""
    box = {}
    with tr.span("http.predict", attrs={"model": "m"}) as root:
        with tr.span("serving.enqueue") as enq:
            ctx = tr.current_context()
            assert ctx.span_id == enq.span_id and \
                ctx.trace_id == root.trace_id

        def worker():
            box["ambient"] = tr.current_context()
            with tr.span("serving.batcher.execute", parent=ctx):
                with tr.span("serving.engine.predict"):
                    pass
            orphan = tr.start_span("serving.batcher.pack")
            box["orphan_new_trace"] = orphan.trace_id != root.trace_id
            orphan.end()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        inner = tr.current_context()
    box["restored"] = (inner.span_id == root.span_id
                       and tr.current_context() is None)
    return root, box


def test_span_nesting_and_cross_thread_parents_match(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TRACE_RETAIN_PCT", "0")
    out = {}
    for k, tr in TRACING.items():
        root, box = _traced_request(tr)
        assert tr.retain_trace(root.trace_id, meta={"k": k})
        kept = tr.retained_trace(root.trace_id)
        doc = tr.export_chrome_trace(root.trace_id)
        out[k] = (_shape(kept["spans"], root.span_id), box["ambient"],
                  box["orphan_new_trace"], box["restored"],
                  sorted(ev["name"] for ev in doc["traceEvents"]),
                  {ev["ph"] for ev in doc["traceEvents"]},
                  all(ev["args"]["trace_id"] == root.trace_id
                      for ev in doc["traceEvents"]))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [
        ("http.predict", None, True),
        ("serving.batcher.execute", "serving.enqueue", False),
        ("serving.engine.predict", "serving.batcher.execute", False),
        ("serving.enqueue", "http.predict", True)]


def test_span_records_errors_alike():
    out = {}
    for k, tr in TRACING.items():
        with pytest.raises(ValueError):
            with tr.span("http.predict") as sp:
                raise ValueError("bad payload")
        rec = [e for e in (jflight if k == "jax" else tflight).get().events()
               if e.get("kind") == "span" and e.get("span_id") == sp.span_id]
        out[k] = rec[0]["attrs"]
    assert out["torch"] == out["jax"] == {"error": "ValueError: bad payload"}


def _normalize_flows(events):
    """Flow events as (name, ph, index of their id among the flows)."""
    ids = []
    out = []
    for ev in events:
        if ev.get("cat") != "handoff":
            continue
        if ev["id"] not in ids:
            ids.append(ev["id"])
        out.append((ev["name"], ev["ph"], ids.index(ev["id"]),
                    ev.get("bp")))
    return out


def test_flows_emit_alike_while_the_profiler_collects():
    out = {}
    for k in ("jax", "torch"):
        tr, prof = TRACING[k], PROF[k]
        prof.dumps(reset=True)
        silent = tr.flow_start("serving.queue")   # not collecting: no event
        prof.set_state("run")
        try:
            a = tr.flow_start("serving.queue")
            b = tr.flow_start("serving.queue")
            tr.flow_end(b, "serving.queue")
            tr.flow_end(a, "serving.queue")
            tr.flow_end(None, "serving.queue")
            with tr.span("serving.batcher.split"):
                pass
            with prof._lock:
                events = list(prof._events)
        finally:
            prof.set_state("stop")
            prof.dumps(reset=True)
        spans = [e["name"] for e in events if e.get("cat") == "span"]
        out[k] = (_normalize_flows(events), spans, isinstance(silent, int))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [("serving.queue", "s", 0, None),
                               ("serving.queue", "s", 1, None),
                               ("serving.queue", "f", 1, "e"),
                               ("serving.queue", "f", 0, "e")]


def test_retention_caps_and_tombstones_match(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TRACE_RETAIN_CAP", "2")
    monkeypatch.setenv("MXNET_TPU_TRACE_PENDING_CAP", "3")
    out = {}
    for k, tr in TRACING.items():
        tr._reset_retention()
        roots = []
        for _ in range(5):
            r = tr.start_span("http.predict")
            with tr.span("serving.enqueue", parent=r.context()):
                pass
            roots.append(r)
        with tr._trace_lock:
            pending = [roots.index(next(x for x in roots
                                        if x.trace_id == t))
                       for t in tr._pending]
        kept = [tr.retain_trace(r.trace_id) for r in roots]
        tr.discard_trace(roots[4].trace_id)
        for r in roots:
            r.end()   # late roots: kept traces grow, dropped stay dropped
        summary = [(roots.index(next(x for x in roots
                                     if x.trace_id == t["trace_id"])),
                    t["n_spans"]) for t in tr.retained_traces()]
        with tr._trace_lock:
            orphans = [t for t in tr._pending
                       if t in {r.trace_id for r in roots}]
        out[k] = (pending, kept, summary, len(orphans))
        tr._reset_retention()
    assert out["torch"] == out["jax"]
    # pending keeps the newest 3; retaining 2, 3, 4 under a cap of 2
    # evicts 2; the late roots complete the kept slices
    assert out["torch"][0] == [2, 3, 4] and out["torch"][2] == [(3, 2),
                                                                (4, 2)]


# ------------------------------------------------------------ flight ring
def test_flight_ring_and_post_mortem_match(tmp_path, monkeypatch):
    out = {}
    for k, fl in (("jax", jflight), ("torch", tflight)):
        rec = fl.FlightRecorder(capacity=16)
        for i in range(40):
            rec.record("event", {"message": f"e{i}"})
        msgs = [e["message"] for e in rec.events()]
        exc = RuntimeError("UNAVAILABLE: backend gone")
        d = tmp_path / k
        monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(d))
        first = rec.notify_fatal(exc, site="execute")
        second = rec.notify_fatal(exc, site="execute")  # rate-limited
        monkeypatch.delenv("MXNET_TPU_FLIGHT_DIR")
        import json
        art = json.loads(open(first).read())
        out[k] = (len(rec), msgs[:2], msgs[-1], second,
                  rec.last_crash["exception"], art["exception"],
                  art["reason"], sorted(art),
                  [e["kind"] for e in art["events"]][-2:])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 16 and out["torch"][1] == ["e24", "e25"]


def test_profiler_stats_providers_and_dumps_match():
    out = {}
    for k, prof in PROF.items():
        prof.register_stats_provider("zz_test", lambda: {"b": 2, "a": 1})
        prof.register_stats_provider("zz_bad", lambda: 1 / 0)
        prof.register_stats_provider("zz_empty", lambda: {})
        js = prof.dumps(format="json")["sections"]
        table = prof.dumps()
        for n in ("zz_test", "zz_bad", "zz_empty"):
            prof.unregister_stats_provider(n)
        out[k] = ({n: js[n] for n in ("zz_test", "zz_bad") if n in js},
                  "zz_empty" in js,
                  table[table.index("[zz_bad]"):].splitlines()[:6])
        with pytest.raises(ValueError):
            prof.register_stats_provider("x", 3)
    assert out["torch"] == out["jax"]
