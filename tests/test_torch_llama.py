"""Port parity: the PyTorch Llama against mxnet_tpu's, on copied weights.

Weights go JAX -> numpy -> ``llama_state_dict_from_mxnet``.  Everything is
float32 on the CPU; tolerance 1e-5 absolute and relative on logits of
magnitude ~0.1..1 (XLA and PyTorch sum the matmuls in other orders), exact
equality for the RoPE tables (built the same way in numpy).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jax_llama_tiny
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import llama_state_dict_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny

VOCAB = 53
MAXLEN = 64
TOL = dict(atol=1e-5, rtol=1e-5)


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


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    return _pair(11, **({"num_kv_heads": 2} if request.param == "gqa" else {}))


def test_forward_logits_match(pair):
    jnet, tnet = pair
    tokens = np.random.RandomState(0).randint(1, VOCAB, (2, 12))
    ref = jnet(mx.nd.array(tokens.astype(np.int32))).asnumpy()
    with torch.no_grad():
        out = tnet(torch.from_numpy(tokens)).numpy()
    assert out.shape == (2, 12, VOCAB)
    np.testing.assert_allclose(out, ref, **TOL)


def test_rope_tables_are_bit_identical(pair):
    jnet, tnet = pair
    np.testing.assert_array_equal(tnet.rope_cos.numpy(),
                                  jnet.rope_cos.data().asnumpy())
    np.testing.assert_array_equal(tnet.rope_sin.numpy(),
                                  jnet.rope_sin.data().asnumpy())


def test_cache_forward_matches(pair):
    """Same chunk, positions, cache lengths, page table and pools through
    both cache_forward implementations: logits and the chunk's K/V."""
    jnet, tnet = pair
    rng = np.random.RandomState(1)
    layers, kv_units, _ = tnet.kv_cache_spec()
    assert (layers, kv_units, MAXLEN) == tuple(jnet.kv_cache_spec())
    pages, page_tokens, chunk = 9, 4, 3
    k_pool = (rng.randn(layers, pages, page_tokens, kv_units) * 0.3).astype(
        np.float32)
    v_pool = (rng.randn(layers, pages, page_tokens, kv_units) * 0.3).astype(
        np.float32)
    tokens = rng.randint(1, VOCAB, (2, chunk)).astype(np.int32)
    positions = np.array([5, 9], np.int32)
    cache_lens = np.array([5, 9], np.int32)
    table = np.array([[3, 1, 0], [2, 7, 4]], np.int32)
    ref = jnet.cache_forward(*(mx.nd.array(a, dtype=a.dtype) for a in
                               (tokens, positions, cache_lens, table)),
                             mx.nd.array(k_pool), mx.nd.array(v_pool))
    with torch.no_grad():
        out = tnet.cache_forward(*(torch.from_numpy(a) for a in
                                   (tokens, positions, cache_lens, table,
                                    k_pool, v_pool)))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r.asnumpy(), **TOL)


def test_dense_forward_matches_cache_forward_on_empty_cache(pair):
    _, tnet = pair
    tokens = torch.from_numpy(np.random.RandomState(2).randint(1, VOCAB, (1, 10)))
    layers, kv_units, _ = tnet.kv_cache_spec()
    empty = torch.zeros(layers, 1, 4, kv_units)
    with torch.no_grad():
        dense = tnet(tokens)
        paged, _, _ = tnet.cache_forward(
            tokens, torch.zeros(1, dtype=torch.long),
            torch.zeros(1, dtype=torch.long),
            torch.zeros(1, 0, dtype=torch.long), empty, empty)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), **TOL)


def test_default_device_is_cuda():
    """Entry points run on the card unless asked for the CPU: without CUDA
    the default raises instead of running on the host."""
    if torch.cuda.is_available():
        assert llama_tiny().device.type == "cuda"
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        llama_tiny()


def test_convert_rejects_mismatched_parameters():
    jnet, tnet = _pair(12)
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    missing = {k: v for k, v in params.items() if "layer1_ffn_w2" not in k}
    with pytest.raises(MXNetError, match="no parameter"):
        llama_state_dict_from_mxnet(missing, tnet)
    extra = dict(params, llamamodel9_spare_weight=np.zeros(3, np.float32))
    with pytest.raises(MXNetError):
        llama_state_dict_from_mxnet(extra, tnet)
