"""Telemetry naming lint for the port: the four contracts of
``tests/test_telemetry_lint.py`` held over ``mxnet_tpu_torch/`` source and
the port's metrics registry, plus the contracts that let one dashboard
read both packages:

* every registered metric family obeys ``mxnet_tpu_<subsystem>_<name>
  [_unit]`` — counters end in ``_total``, histograms in a base unit;
* every ``MXNET_*`` knob mentioned in the port's source is declared in its
  ``base.py`` registry with a real docstring, under the JAX package's name
  and default where the JAX package has it;
* every literal span name in the port's source is ``subsystem.verb`` with
  the subsystem drawn from ``tracing.SPAN_SUBSYSTEMS`` (the JAX
  package's set), and is a span name the JAX package uses;
* every ``_seconds``/``_bytes``/``_rows``/``_ratio`` histogram declares a
  bucket ladder consistent with its unit;
* every family of the port exists under the same name, kind and labels in
  the JAX package's registry.
"""
import pathlib
import re

import pytest

import mxnet_tpu as jmx
import mxnet_tpu.base as jbase
import mxnet_tpu.observability.metrics as jmetrics
import mxnet_tpu.observability.tracing as jtracing
# importing these registers the JAX package's module-level families
import mxnet_tpu.cached_op        # noqa: F401
import mxnet_tpu.executor         # noqa: F401
import mxnet_tpu.resilience       # noqa: F401
import mxnet_tpu.serving.generation  # noqa: F401
import mxnet_tpu.serving.paged_cache  # noqa: F401
import mxnet_tpu.serving.stats    # noqa: F401
import mxnet_tpu.observability.goodput  # noqa: F401
import mxnet_tpu.observability.health   # noqa: F401
import mxnet_tpu.observability.memory   # noqa: F401

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import env
from mxnet_tpu_torch.observability import metrics, tracing
# and the port's
import mxnet_tpu_torch.cached_op        # noqa: F401
import mxnet_tpu_torch.executor         # noqa: F401
import mxnet_tpu_torch.resilience       # noqa: F401
import mxnet_tpu_torch.serving          # noqa: F401
import mxnet_tpu_torch.serving.server   # noqa: F401
import mxnet_tpu_torch.observability.goodput  # noqa: F401
import mxnet_tpu_torch.observability.health   # noqa: F401
import mxnet_tpu_torch.observability.memory   # noqa: F401

PKG = pathlib.Path(tmx.__file__).parent
JPKG = pathlib.Path(jmx.__file__).parent
_HIST_UNITS = ("seconds", "bytes", "rows", "ratio")
# the port's families: the JAX package's registry also holds families
# declared by tests of the suite's other files in this process, which is
# why the port's registry is read, not a name list
_FAMILIES = metrics.registry().collect()


def _sources(root):
    return [p for p in root.rglob("*.py") if "__pycache__" not in p.parts]


def test_metric_names_follow_convention():
    assert len(_FAMILIES) >= 30, "expected the ported subsystems registered"
    for m in _FAMILIES:
        assert metrics.METRIC_NAME_RE.match(m.name), m.name
        segments = m.name.split("_")
        assert segments[:2] == ["mxnet", "tpu"] and len(segments) >= 4, m.name
        if m.kind == "counter":
            assert m.name.endswith("_total"), m.name
        if m.kind == "histogram":
            assert m.name.endswith(_HIST_UNITS), m.name


def test_known_subsystem_prefixes():
    subsystems = {m.name.split("_")[2] for m in _FAMILIES}
    for expected in ("serving", "resilience", "cachedop", "goodput",
                     "memory", "health"):
        assert expected in subsystems, (expected, subsystems)


@pytest.mark.parametrize("m", _FAMILIES, ids=lambda m: m.name)
def test_family_exists_in_the_jax_registry(m):
    ref = jmetrics.registry().get(m.name)
    assert ref is not None, f"{m.name} is not a JAX package family"
    assert (ref.kind, ref.labelnames) == (m.kind, m.labelnames), m.name
    if m.kind == "histogram":
        assert ref._buckets == m._buckets, m.name


def test_every_mxnet_env_knob_is_declared():
    mentions = {}
    for p in _sources(PKG):
        src = p.read_text()
        names = set(re.findall(r"['\"`(](MXNET_[A-Z0-9_]{2,})\b", src))
        names |= set(re.findall(r"\benv\.(MXNET_[A-Z0-9_]+)", src))
        names |= set(re.findall(r"``(MXNET_[A-Z0-9_]+)", src))
        for n in names:
            mentions.setdefault(n, []).append(str(p.relative_to(PKG)))
    assert len(mentions) >= 20, "scan found too little — pattern rot?"
    undeclared = {n: f for n, f in sorted(mentions.items()) if n not in env}
    assert not undeclared, undeclared


def test_declared_knobs_have_docs_and_the_jax_defaults():
    for name in env.names():
        flag = env._flags[name]
        assert flag.doc and len(flag.doc) > 10, name
        if name in jbase.env:
            ref = jbase.env._flags[name]
            assert (flag.default, flag.typ) == (ref.default, ref.typ), name


_SPAN_CALL_RE = re.compile(
    r"""(?<!\w)(?:span|start_span)\(\s*(['"])([a-z0-9_.]+)\1""")


def _span_literals(root):
    found = {}
    for p in _sources(root):
        for m in _SPAN_CALL_RE.finditer(p.read_text()):
            found.setdefault(m.group(2), []).append(str(p.relative_to(root)))
    return found


def test_span_names_are_dotted_registered_and_the_jax_names():
    found = _span_literals(PKG)
    assert len(found) >= 10, f"span scan found too little: {found}"
    assert tracing.SPAN_SUBSYSTEMS == jtracing.SPAN_SUBSYSTEMS
    jax_names = set(_span_literals(JPKG))
    for name, files in sorted(found.items()):
        assert re.match(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$", name), (name, files)
        assert name.split(".", 1)[0] in tracing.SPAN_SUBSYSTEMS, name
        assert name in jax_names, f"{name} ({files}) is not a JAX span name"


def test_histogram_ladders_match_units():
    for m in _FAMILIES:
        if m.kind != "histogram":
            continue
        b = m._buckets
        assert b and list(b) == sorted(set(b)), m.name
        if m.name.endswith("_seconds"):
            assert 1e-9 <= b[0] and b[-1] <= 86400, m.name
        elif m.name.endswith(("_bytes", "_rows")):
            assert b[0] >= 1, m.name
        elif m.name.endswith("_ratio"):
            assert 0.0 <= b[0] and b[-1] <= 1.0 + 1e-9, m.name
