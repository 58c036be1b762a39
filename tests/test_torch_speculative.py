"""Port parity: speculative decoding on the PyTorch paged engine against the
JAX package's solo ``greedy_decode`` of the target, on copied weights,
float32 on the CPU.

The draft proposes, the target verifies ``spec_tokens + 1`` rows at once
and greedy accept/rollback keeps the target-only greedy stream, so the
oracle is the JAX package's greedy decode of the target alone; tokens are
held to it under tests/test_torch_generation.py's near-tie rule
(``NEAR_TIE``, ``_assert_tokens``).  Mirrors tests/test_paged_generation.py
(speculation over MHA and GQA, eos mid-speculation, fault isolation, the
server surface), with the draft pool's accounting (submit check, cancel,
a ``decode`` fault) and the speculation counters.
"""
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import GenerationScheduler as JaxScheduler
from mxnet_tpu.serving import greedy_decode as jax_greedy_decode
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.observability import metrics
from mxnet_tpu_torch.resilience import FaultInjected, FaultPlan
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.serving.server import Client
from test_torch_generation import (MAXLEN, PAGE, VOCAB, _assert_tokens,
                                   _pair, _sched)

SPEC = 4


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
def gqa():
    return _pair(3, num_kv_heads=2)


@pytest.fixture(scope="module")
def draft():
    """A 1-layer draft with the target's vocabulary (random: it is
    rejected often)."""
    return _pair(7, num_layers=1)


_ORACLE = {}


def _oracle(jnet, prompts, budgets, eos_id=None):
    """The JAX package's solo greedy tokens of the target."""
    out = []
    for p, m in zip(prompts, budgets):
        key = (id(jnet), tuple(p), m, eos_id)
        if key not in _ORACLE:
            _ORACLE[key] = jax_greedy_decode(jnet, p, max_new_tokens=m,
                                             eos_id=eos_id, min_bucket=8,
                                             max_length=MAXLEN)
        out.append(_ORACLE[key])
    return out


def _counter(name, model):
    return metrics.registry().get(name).labels(model=model).value


def _drained(sched):
    snap = sched.stats_snapshot()
    return (snap["page_pool"]["active"] == 0
            and snap["draft_page_pool"]["active"] == 0)


@pytest.mark.parametrize("spec", [1, 2, 4])
@pytest.mark.parametrize("target", ["mha", "gqa"])
def test_speculative_matches_jax_greedy(target, spec, mha, gqa, draft):
    """Staggered admission, prompts crossing 4-token pages, a random
    1-layer draft: the target-only greedy stream, and both pools drained
    after every retirement."""
    jnet, tnet = {"mha": mha, "gqa": gqa}[target]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (3, 6, 2, 9)]
    budgets = [6, 4, 7, 5]
    want = _oracle(jnet, prompts, budgets)
    name = f"spec-{target}-{spec}"
    sched = _sched(tnet, max_slots=2, draft_model=draft[1], spec_tokens=spec,
                   name=name)
    assert sched.spec_tokens == spec
    counters = ("mxnet_tpu_serving_decode_tokens_total",
                "mxnet_tpu_serving_spec_proposed_total",
                "mxnet_tpu_serving_spec_accepted_total")
    before = [_counter(c, name) for c in counters]
    futs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts[:2], budgets[:2])]
    sched.step()
    futs += [sched.submit(p, max_new_tokens=m)
             for p, m in zip(prompts[2:], budgets[2:])]
    sched.run()
    got = [f.result(timeout=0) for f in futs]
    _assert_tokens(jnet, prompts, got, want)
    snap = sched.stats_snapshot()
    assert snap["spec_tokens"] == spec
    assert 0.0 <= snap["spec_acceptance"] <= 1.0
    assert _drained(sched)
    tokens, proposed, accepted = (_counter(c, name) - b
                                  for c, b in zip(counters, before))
    # tokens emitted, not logits rows sampled (a verify samples spec + 1)
    assert tokens == sum(len(g) for g in got)
    assert snap["logit_rows"] > sum(budgets)
    # spec proposals per active slot and round; the acceptance is theirs
    assert proposed > 0 and proposed % spec == 0 and 0 <= accepted <= proposed
    assert snap["spec_acceptance"] == pytest.approx(accepted / proposed)


@pytest.mark.parametrize("drafter", ["self", "random"])
def test_eos_mid_speculation(mha, draft, drafter):
    """An eos inside a round truncates the round there.  This prompt's
    greedy stream is one token, then another repeated; the second is the
    eos.  The target as its own draft proposes it four times, all
    accepted, and the round keeps only the first."""
    jnet, tnet = mha
    prompt = np.random.RandomState(16).randint(1, VOCAB, 7).tolist()
    solo = _oracle(jnet, [prompt], [12])[0]
    k = next(i for i in range(1, len(solo)) if solo[i] not in solo[:i])
    eos = solo[k]
    want = _oracle(jnet, [prompt], [12], eos_id=eos)
    assert len(want[0]) == k + 1 < 12
    dnet = tnet if drafter == "self" else draft[1]
    sched = _sched(tnet, max_slots=1, draft_model=dnet, spec_tokens=SPEC,
                   eos_id=eos, name=f"spec-eos-{drafter}")
    fut = sched.submit(prompt, max_new_tokens=12)
    sched.run()
    _assert_tokens(jnet, [prompt], [fut.result(timeout=0)], want)
    assert fut.result(timeout=0)[-1] == eos
    assert _drained(sched)
    if drafter == "self":
        # one round after the prefill, its accepted proposals cut at the eos
        assert sched.steps == 1
        assert sched.stats_snapshot()["spec_acceptance"] > 0.5


def test_submit_checks_the_draft_pool_like_jax(mha, draft):
    """A request whose target pages fit but whose draft pages (budget plus
    the speculative overrun) do not is refused at submit, with the JAX
    package's error."""
    jnet, tnet = mha
    errors = []
    for sched in (_sched(tnet, max_slots=1, num_pages=4,
                         draft_model=draft[1], spec_tokens=SPEC),
                  JaxScheduler(jnet, max_slots=1, min_bucket=8,
                               max_length=MAXLEN, page_tokens=PAGE,
                               num_pages=4, draft_model=draft[0],
                               spec_tokens=SPEC)):
        sched.submit([1] * 4, max_new_tokens=4)   # 2 + 2 draft pages: fits
        with pytest.raises(Exception, match="DRAFT KV pages") as exc:
            sched.submit([1] * 8, max_new_tokens=4)   # 3 pages, draft 4
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_cancel_mid_flight_frees_draft_pages(mha, draft):
    jnet, tnet = mha
    sched = _sched(tnet, max_slots=2, draft_model=draft[1], spec_tokens=SPEC,
                   prefix_cache=False)
    keep = sched.submit([3, 1, 4, 1, 5], max_new_tokens=6, rid="keep")
    drop = sched.submit([9, 2, 6], max_new_tokens=9, rid="drop")
    sched.step()                      # both admitted, one round each
    before = sched.stats_snapshot()["draft_page_pool"]["active"]
    # ceil((5 + 6 + 4) / 4) and ceil((3 + 9 + 4) / 4) draft pages
    assert before == 4 + 4 and len(sched._rids["drop"].dpages) == 4
    assert sched.cancel("drop")
    assert sched.stats_snapshot()["draft_page_pool"]["active"] == before - 4
    sched.run()
    with pytest.raises(Exception, match="cancelled"):
        drop.result(timeout=0)
    _assert_tokens(jnet, [[3, 1, 4, 1, 5]], [keep.result(timeout=0)],
                   _oracle(jnet, [[3, 1, 4, 1, 5]], [6]))
    assert _drained(sched)


def test_decode_fault_in_a_speculative_round_frees_both_pools(mha, draft):
    """A ``decode`` fault on the draft's second chunk fails every active
    future and releases both pools; the scheduler serves on."""
    jnet, tnet = mha
    sched = _sched(tnet, max_slots=2, draft_model=draft[1], spec_tokens=SPEC,
                   prefix_cache=False)
    futs = [sched.submit(p, max_new_tokens=8) for p in ([1, 2, 3], [4, 5])]
    sched.step()                      # admission and one round, no fault
    with FaultPlan({"decode": ["ok", "fatal"]}) as plan:
        sched.step()
    assert plan.triggered == [("decode", "ok"), ("decode", "fatal")]
    for f in futs:
        assert isinstance(f.exception(timeout=0), FaultInjected)
    assert _drained(sched) and sched.stats_snapshot()["active"] == 0
    again = sched.submit([4, 5], max_new_tokens=3)
    sched.run()
    _assert_tokens(jnet, [[4, 5]], [again.result(timeout=0)],
                   _oracle(jnet, [[4, 5]], [3]))
    assert _drained(sched)


def test_register_generation_with_draft_and_warmup(mha, draft):
    """``register_generation(draft_model=..., warmup=True)``: the family is
    made before traffic, ``generate`` and ``POST /generate`` give the JAX
    greedy tokens without a new entry, and /stats and /metrics carry the
    speculation fields."""
    jnet, tnet = mha
    prompts = [[5, 7, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18]]
    want = _oracle(jnet, prompts, [6, 5])
    server = ModelServer()
    try:
        sched = server.register_generation(
            "lm-spec", tnet, max_slots=2, min_bucket=8, max_length=MAXLEN,
            page_tokens=PAGE, draft_model=draft[1], spec_tokens=2,
            warmup=True, warmup_prompt_len=9)
        entries = (sched.cache_stats["entries"],
                   sched._draft.cache_stats["entries"])
        assert entries[0] > 0 and entries[1] > 0
        got = [server.generate("lm-spec", prompts[0], max_new_tokens=6)]
        url = f"http://127.0.0.1:{server.start_http(port=0)}"
        client = Client(url)
        got.append(client.generate("lm-spec", prompts[1], max_new_tokens=5))
        _assert_tokens(jnet, prompts, got, want)
        assert (sched.cache_stats["entries"],
                sched._draft.cache_stats["entries"]) == entries
        st = client.stats("lm-spec")
        assert st["spec_tokens"] == 2 and 0.0 <= st["spec_acceptance"] <= 1
        assert st["draft_page_pool"]["active"] == 0
        assert st["compile_cache"]["entries"] == entries[0]
        assert "signatures" not in st["compile_cache"]
        with urllib.request.urlopen(url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert 'mxnet_tpu_serving_spec_proposed_total{model="lm-spec"}' \
            in text
        assert "[generation:lm-spec]" in profiler.dumps()
    finally:
        server.stop(timeout=10)
