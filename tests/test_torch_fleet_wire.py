"""The K/V handoff wire between the two packages: a JAX replica and a port
replica speak the same ``"kv"`` payload (base64 float32 ``[layers,
tokens, kv_units]``), on the CPU.

* ``encode_kv`` gives the same bytes in both packages on the same arrays,
  and each package's ``decode_kv`` reads the other's payload exactly;
* a JAX ``prefill_only`` payload admitted by a port decode scheduler, and
  a port payload admitted by a JAX decode scheduler, each give the JAX
  mixed scheduler's tokens (tests/test_torch_generation.py's near-tie
  rule), and the two packages' exported K/V agree within 1e-5 (fp32);
* the port's Router disaggregates over a JAX prefill replica and a port
  decode replica, and the other way round, over HTTP.

The weights are the JAX llama_tiny's (vocab 53, max_length 64, 4-token
pages), carried across by ``convert.llama_state_dict_from_mxnet``.
"""
import json

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import GenerationScheduler as JaxScheduler
from mxnet_tpu.serving import ModelServer as JaxServer
from mxnet_tpu.serving.server import decode_kv as jax_decode_kv
from mxnet_tpu.serving.server import encode_kv as jax_encode_kv
from mxnet_tpu_torch.fleet import Router
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.serving.server import decode_kv, encode_kv
from test_torch_generation import (MAXLEN, PAGE, VOCAB, _assert_tokens,
                                   _pair, _sched)

KV_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    return _pair(0)


def _jax_sched(jnet, name):
    return JaxScheduler(jnet, name=name, max_slots=2, min_bucket=8,
                        max_length=MAXLEN, page_tokens=PAGE)


def _port_sched(tnet, name):
    return _sched(tnet, name=name, max_slots=2)


def _jax_mixed(jnet, prompt, max_new):
    sched = _jax_sched(jnet, "wire-jax-mixed")
    fut = sched.submit(prompt, max_new_tokens=max_new)
    sched.run()
    return fut.result(timeout=0)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 8), (1, 0, 4)])
def test_encode_kv_bytes_equal_and_decode_crosses(shape):
    rng = np.random.RandomState(sum(shape))
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float64)   # widened: both narrow it
    ours, theirs = encode_kv(k, v, 7), jax_encode_kv(k, v, 7)
    assert json.dumps(ours) == json.dumps(theirs)
    for dec, wire in ((decode_kv, theirs), (jax_decode_kv, ours)):
        got = dec({"kv": wire})
        assert got["first_token"] == 7
        np.testing.assert_array_equal(got["k"], k)
        np.testing.assert_array_equal(got["v"], v.astype(np.float32))
    assert decode_kv({}) is None and jax_decode_kv({}) is None


@pytest.mark.parametrize("n,m", [(3, 5), (8, 4), (13, 6)])
def test_prefill_payloads_cross_between_packages(llama, n, m):
    """JAX prefill_only -> port decode scheduler, port prefill_only -> JAX
    decode scheduler: both give the JAX mixed scheduler's tokens, and the
    two exports' first tokens, hashes and K/V agree."""
    jnet, tnet = llama
    prompt = np.random.RandomState(100 + n).randint(1, VOCAB, n).tolist()
    want = _jax_mixed(jnet, prompt, m)
    jout = _jax_sched(jnet, "wire-jax-pre").prefill_only(prompt, m)
    tout = _port_sched(tnet, "wire-port-pre").prefill_only(prompt, m)
    assert tout["first_token"] == jout["first_token"]
    assert tout["hashes"] == jout["hashes"]
    assert tout["page_tokens"] == jout["page_tokens"] == PAGE
    for key in ("k", "v"):
        assert tout[key].shape == jout[key].shape == (2, n, 64)
        assert np.abs(tout[key] - jout[key]).max() <= KV_TOL
    # JAX payload -> port decode
    port_dec = _port_sched(tnet, "wire-port-dec")
    fut = port_dec.submit(prompt, max_new_tokens=m, ext_kv=decode_kv(
        {"kv": jax_encode_kv(jout["k"], jout["v"], jout["first_token"])}))
    port_dec.run()
    # port payload -> JAX decode
    jax_dec = _jax_sched(jnet, "wire-jax-dec")
    jfut = jax_dec.submit(prompt, max_new_tokens=m, ext_kv=jax_decode_kv(
        {"kv": encode_kv(tout["k"], tout["v"], tout["first_token"])}))
    jax_dec.run()
    _assert_tokens(jnet, [prompt, prompt],
                   [fut.result(timeout=0), jfut.result(timeout=0)],
                   [want, want])
    assert {sig[0][0][0][1]
            for sig in port_dec.cache_stats["signatures"]} == {1}


@pytest.mark.parametrize("prefill", ["jax", "torch"])
def test_router_disaggregates_across_packages(llama, prefill):
    """The port's Router over a prefill replica of one package and a
    decode replica of the other: the K/V crosses HTTP between packages
    and the tokens are the JAX mixed scheduler's."""
    jnet, tnet = llama
    servers = {
        "jax": lambda role, name: (JaxServer(role=role),
                                   _jax_sched(jnet, name)),
        "torch": lambda role, name: (ModelServer(role=role),
                                     _port_sched(tnet, name))}
    decode = "torch" if prefill == "jax" else "jax"
    started = []
    try:
        urls = []
        for pkg, role in ((prefill, "prefill"), (decode, "decode")):
            srv, sched = servers[pkg](role, f"wire-{pkg}-{role}-http")
            srv.register_generation("lm", None, scheduler=sched,
                                    warmup=False)
            started.append(srv)
            urls.append((f"http://127.0.0.1:{srv.start_http('127.0.0.1', 0)}",
                         role))
        router = Router(urls, poll_s=999)
        assert router._disaggregated()
        prompt = np.random.RandomState(7).randint(1, VOCAB, 10).tolist()
        code, body = router.route_generate(
            "lm", {"prompt": prompt, "max_new_tokens": 6})
        assert code == 200, body
        _assert_tokens(jnet, [prompt], [body["tokens"]],
                       [_jax_mixed(jnet, prompt, 6)])
    finally:
        for srv in started:
            srv.stop(timeout=10)
