"""Port parity: the PyTorch generation schedulers (paged and dense engines)
and ModelServer against the JAX package's solo ``greedy_decode``, on
copied weights, float32 on the CPU.

Tokens must be equal.  Where one differs, the test shows that the JAX
logits' top-2 margin at that step is a near-tie (below NEAR_TIE, a few
float32 roundings of logits of magnitude ~1) rather than a fault, and
stops comparing that request there.  Mirrors tests/test_paged_generation.py
(staggered admission across page boundaries, MHA and GQA, server surface).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving import greedy_decode as jax_greedy_decode
from mxnet_tpu.serving.generation import length_bucket as jax_length_bucket
from mxnet_tpu_torch.base import RequestCancelledError, ServerClosedError
from mxnet_tpu_torch.convert import llama_state_dict_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny
from mxnet_tpu_torch.serving import (GenerationScheduler, ModelServer,
                                     greedy_decode, length_bucket)

VOCAB = 53
MAXLEN = 64
PAGE = 4  # small pages so short prompts span page boundaries
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, **kw):
    mx.random.seed(seed)
    jnet = jax_llama_tiny(vocab_size=VOCAB, max_length=MAXLEN, **kw)
    jnet.collect_params().initialize()
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = llama_tiny(vocab_size=VOCAB, max_length=MAXLEN, device="cpu", **kw)
    llama_state_dict_from_mxnet(params, tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def mha():
    return _pair(0)


@pytest.fixture(scope="module")
def gqa():
    return _pair(3, num_kv_heads=2)


_ORACLE = {}


def _oracle(jnet, prompts, budgets):
    """The JAX package's solo greedy tokens, computed once per request."""
    out = []
    for p, m in zip(prompts, budgets):
        key = (id(jnet), tuple(p), m)
        if key not in _ORACLE:
            _ORACLE[key] = jax_greedy_decode(jnet, p, max_new_tokens=m,
                                             min_bucket=8, max_length=MAXLEN)
        out.append(_ORACLE[key])
    return out


def _margin(jnet, tokens):
    """Top-2 gap of the JAX logits for the token after ``tokens``."""
    L = jax_length_bucket(len(tokens), 8, MAXLEN)
    arr = np.zeros((1, L), np.int32)
    arr[0, :len(tokens)] = tokens
    row = np.sort(jnet(mx.nd.array(arr)).asnumpy()[0, len(tokens) - 1])
    return float(row[-1] - row[-2])


def _assert_tokens(jnet, prompts, got, want):
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        margin = _margin(jnet, list(prompt) + w[:j])
        assert margin < NEAR_TIE, (
            f"prompt {prompt}: port {g} vs JAX {w} differ at step {j} where "
            f"the JAX top-2 margin is {margin:.3g}, not a near-tie")


def _sched(net, **kw):
    kw.setdefault("min_bucket", 8)
    kw.setdefault("max_length", MAXLEN)
    kw.setdefault("page_tokens", PAGE)
    return GenerationScheduler(net, **kw)


@pytest.mark.parametrize("kv_cache", [True, False], ids=["paged", "dense"])
def test_scheduler_matches_jax_greedy_across_page_boundaries(mha, kv_cache):
    """Staggered admission and retirement, with sequence lengths crossing
    4-token page boundaries mid-decode."""
    jnet, tnet = mha
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (3, 4, 5, 9, 2)]
    budgets = [5, 3, 7, 4, 6]
    want = _oracle(jnet, prompts, budgets)
    sched = _sched(tnet, max_slots=3, kv_cache=kv_cache)
    assert sched.paged == kv_cache
    futs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts[:3], budgets[:3])]
    sched.step()
    futs += [sched.submit(p, max_new_tokens=m)
             for p, m in zip(prompts[3:], budgets[3:])]
    sched.run()
    _assert_tokens(jnet, prompts, [f.result(timeout=0) for f in futs], want)
    snap = sched.stats_snapshot()
    assert snap["nonfinite_rows"] == 0 and snap["logit_rows"] == sum(budgets)
    if kv_cache:
        assert snap["page_pool"]["active"] == 0  # every retirement recycled


@pytest.mark.parametrize("kv_cache", [True, False], ids=["paged", "dense"])
def test_scheduler_matches_jax_greedy_gqa(gqa, kv_cache):
    jnet, tnet = gqa
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (4, 17)]
    budgets = [6, 7]
    want = _oracle(jnet, prompts, budgets)
    sched = _sched(tnet, max_slots=2, kv_cache=kv_cache)
    futs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    sched.run()
    _assert_tokens(jnet, prompts, [f.result(timeout=0) for f in futs], want)


def test_prefix_cache_hit_keeps_tokens(mha):
    """A second request sharing two complete pages maps them from the
    prefix cache and still decodes the oracle's tokens."""
    jnet, tnet = mha
    shared = np.random.RandomState(6).randint(1, VOCAB, 9).tolist()
    prompts = [shared, shared[:8] + [7, 9]]
    want = _oracle(jnet, prompts, [4, 5])
    sched = _sched(tnet, max_slots=1)
    first = sched.submit(prompts[0], max_new_tokens=4)
    sched.run()
    second = sched.submit(prompts[1], max_new_tokens=5)
    sched.run()
    assert sched.stats_snapshot()["page_pool"]["prefix_hits"] == 2
    _assert_tokens(jnet, prompts, [first.result(0), second.result(0)], want)


def test_port_greedy_decode_and_length_bucket(mha):
    jnet, tnet = mha
    prompt = [3, 1, 4, 1, 5]
    _assert_tokens(jnet, [prompt],
                   [greedy_decode(tnet, prompt, 6, min_bucket=8,
                                  max_length=MAXLEN)],
                   _oracle(jnet, [prompt], [6]))
    for n in (1, 8, 9, 33, 64):
        assert length_bucket(n, 8, MAXLEN) == jax_length_bucket(n, 8, MAXLEN)


def test_submit_checks_and_cancel(mha):
    _, tnet = mha
    sched = _sched(tnet, max_slots=1)
    with pytest.raises(Exception, match="empty prompt"):
        sched.submit([])
    with pytest.raises(Exception, match="exceeds max_length"):
        sched.submit([1] * 60, max_new_tokens=8)
    keep = sched.submit([1, 2, 3], max_new_tokens=3, rid="keep")
    drop = sched.submit([4, 5, 6], max_new_tokens=3, rid="drop")
    sched.step()                     # "keep" is admitted, "drop" waits
    assert sched.cancel("drop") and not sched.cancel("drop")
    with pytest.raises(RequestCancelledError):
        drop.result(timeout=0)
    sched.run()
    assert len(keep.result(timeout=0)) == 3
    assert sched.stats_snapshot()["page_pool"]["active"] == 0


def test_model_server_generation(mha):
    """register_generation drives a background step loop; generate and
    generate_stream return the oracle's tokens; stop refuses new work."""
    jnet, tnet = mha
    want = _oracle(jnet, [[5, 7, 11]], [4])[0]
    with ModelServer() as server:
        server.register_generation("lm", tnet, max_slots=2, min_bucket=8,
                                   max_length=MAXLEN, page_tokens=PAGE)
        server.register_generation("lm_dense", tnet, max_slots=2,
                                   min_bucket=8, max_length=MAXLEN,
                                   kv_cache=False)
        assert server.models() == ["lm", "lm_dense"]
        for name in server.models():
            out = server.generate(name, [5, 7, 11], max_new_tokens=4)
            _assert_tokens(jnet, [[5, 7, 11]], [out], [want])
            streamed = list(server.generate_stream(name, [5, 7, 11],
                                                   max_new_tokens=4))
            assert streamed == out
        st = server.stats("lm")
        assert st["engine"] == "paged" and st["requests"] == 2
        assert server.stats("lm_dense")["engine"] == "dense"
    with pytest.raises(Exception):
        server.generate("lm", [1, 2])
    with pytest.raises(ServerClosedError):
        server._generators["lm"].submit([1, 2], 2, None)
