"""Port parity: ``GenerationScheduler.warmup`` makes the JAX package's
executable family, one CachedOp entry per JAX executable.

The same scheduler configuration (float32 llama_tiny, vocab 53,
max_length 64, 4-token pages, weights carried across) is warmed in both
packages.  The entries made, and the set of each signature's first four
input shapes (tokens, positions, lengths, page table: the inputs that
vary per call; the JAX key adds the page pools), must be equal for the
dense, paged and speculative engines and for each role.  Live traffic
after warmup, a prefix-cache hit included, adds no entry, and its tokens
are the JAX greedy tokens under tests/test_torch_generation.py's near-tie
rule.  The snapshots carry the JAX package's keys.  Mirrors
tests/test_paged_generation.py (warmup gate) and tests/test_fleet.py
(role-restricted warmup).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.serving import GenerationScheduler as JaxScheduler
from mxnet_tpu.serving import greedy_decode as jax_greedy_decode
from mxnet_tpu_torch.base import MXNetError
from test_torch_generation import (MAXLEN, PAGE, VOCAB, _assert_tokens,
                                   _pair, _sched)

# the port's snapshot also counts the logits rows it copies to the host
PORT_ONLY_KEYS = {"logit_rows", "nonfinite_rows"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mha():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    return _pair(7, num_layers=1)


def _both(mha, draft, engine, **kw):
    """(JAX scheduler, port scheduler) of one configuration."""
    kw.update(max_slots=2, min_bucket=8, max_length=MAXLEN)
    if engine == "dense":
        kw["kv_cache"] = False
    else:
        kw["page_tokens"] = PAGE
    if engine == "spec":
        kw["spec_tokens"] = 3
    jd = {"draft_model": draft[0]} if engine == "spec" else {}
    td = {"draft_model": draft[1]} if engine == "spec" else {}
    return (JaxScheduler(mha[0], name=f"jax-{engine}", **jd, **kw),
            _sched(mha[1], name=f"torch-{engine}", **td, **kw))


def _shapes(stats):
    """Each signature's first four input shapes."""
    return {tuple(tuple(shape) for shape, _ in sig[0][:4])
            for sig in stats["signatures"]}


def _families(sched):
    """(target or dense signatures, draft signatures)."""
    d = getattr(sched, "_draft", None)   # the JAX dense engine has none
    return (_shapes(sched.cache_stats),
            _shapes(d.cache_stats) if d is not None else set())


def _entries(sched):
    d = getattr(sched, "_draft", None)
    return (sched.cache_stats["entries"],
            d.cache_stats["entries"] if d is not None else 0)


@pytest.mark.parametrize("engine", ["dense", "paged", "spec"])
def test_warmup_makes_the_jax_family_and_traffic_adds_none(mha, draft,
                                                           engine):
    jsched, tsched = _both(mha, draft, engine)
    n = {k: s.warmup(max_prompt_len=9, max_new_tokens=8)
         for k, s in (("jax", jsched), ("torch", tsched))}
    assert n["torch"] == n["jax"] > 0
    assert _families(tsched) == _families(jsched)
    warm = _entries(tsched), _entries(jsched)

    rng = np.random.RandomState(6)
    shared = rng.randint(1, VOCAB, 9).tolist()
    prompts = [rng.randint(1, VOCAB, 3).tolist(), shared,
               rng.randint(1, VOCAB, 5).tolist(), shared]
    budgets = [8, 6, 4, 6]
    got = {}
    for k, s in (("jax", jsched), ("torch", tsched)):
        futs = [s.submit(p, max_new_tokens=b)
                for p, b in zip(prompts[:3], budgets[:3])]
        s.run()
        futs.append(s.submit(prompts[3], max_new_tokens=budgets[3]))
        s.run()                    # the prefix-cache hit: shared's 2 pages
        got[k] = [f.result(timeout=0) for f in futs]
    want = [jax_greedy_decode(mha[0], p, max_new_tokens=b, min_bucket=8,
                              max_length=MAXLEN)
            for p, b in zip(prompts, budgets)]
    assert got["jax"] == want
    _assert_tokens(mha[0], prompts, got["torch"], want)
    assert (_entries(tsched), _entries(jsched)) == warm

    jsnap, tsnap = jsched.stats_snapshot(), tsched.stats_snapshot()
    assert set(tsnap) == set(jsnap) | PORT_ONLY_KEYS
    assert set(tsnap["compile_cache"]) == set(jsnap["compile_cache"])
    assert tsnap["compile_cache"] == {"entries": warm[0][0],
                                      "hits": tsnap["compile_cache"]["hits"],
                                      "misses": warm[0][0]}
    if engine != "dense":
        assert tsnap["page_pool"]["prefix_hits"] == 2
        assert tsnap["page_pool"]["active"] == 0
    if engine == "spec":
        assert tsnap["spec_tokens"] == jsnap["spec_tokens"] == 3
        assert 0.0 <= tsnap["spec_acceptance"] <= 1.0
        assert tsnap["draft_page_pool"]["active"] == 0


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_warmup_role_restricts_the_family_like_jax(mha, draft, role):
    """A prefill replica warms the [1, L] chunk ladder only; a decode one
    the [slots, 1] ladder with the verify and draft families."""
    jsched, tsched = _both(mha, draft, "spec")
    n = {k: s.warmup(max_prompt_len=8, max_new_tokens=4, role=role)
         for k, s in (("jax", jsched), ("torch", tsched))}
    assert n["torch"] == n["jax"] > 0
    target, drafted = _families(tsched)
    assert (target, drafted) == _families(jsched)
    if role == "prefill":
        assert {s[0][0] for s in target} == {1} and not drafted
        assert all(s[0][1] > 1 for s in target)
    else:
        assert {s[0] for s in target} == {(2, 1), (2, 4)}
        assert {s[0][1] for s in drafted} == {1, 2, 8}


def test_unknown_role_raises_like_jax(mha, draft):
    jsched, tsched = _both(mha, draft, "paged")
    with pytest.raises(mx.MXNetError, match="unknown warmup role") as j:
        jsched.warmup(max_prompt_len=8, role="both")
    with pytest.raises(MXNetError, match="unknown warmup role") as t:
        tsched.warmup(max_prompt_len=8, role="both")
    assert str(t.value) == str(j.value)
    assert _entries(tsched) == (0, 0)
