"""Port parity: mxnet_tpu_torch.serving.paged_cache against
mxnet_tpu.serving.paged_cache.  Hashes must be byte-identical and the same
allocation sequence must hand out the same page ids; page contents written
through both pools must be equal (exact: writes copy values)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serving import paged_cache as jpc
from mxnet_tpu_torch.serving import paged_cache as tpc


@pytest.mark.parametrize("page_tokens", [1, 4, 16])
def test_page_hash_chain_is_byte_identical(page_tokens):
    tokens = np.random.RandomState(page_tokens).randint(0, 32000, 70).tolist()
    assert (tpc.page_hash_chain(tokens, page_tokens)
            == jpc.page_hash_chain(tokens, page_tokens))
    assert tpc.pages_needed(70, page_tokens) == jpc.pages_needed(70, page_tokens)


def _script(pool, page_tokens):
    """Allocate, register, release, match, reclaim: every id handed out."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 50, 3 * page_tokens).tolist()
    out = []
    a = pool.allocate(3)
    for pid, hsh in zip(a, tpc.page_hash_chain(shared, page_tokens)):
        pool.register(pid, hsh)
    b = pool.allocate(2)
    out += [a, b, pool.available()]
    pool.release(a)            # hashed pages park in the cached LRU
    out.append(pool.available())
    hit = pool.match_prefix(tpc.page_hash_chain(shared, page_tokens)[:2])
    out.append(hit)            # resurrected from the LRU
    c = pool.allocate(pool.available())  # drains free, reclaims the rest
    out += [c, pool.available()]
    pool.release(b + c + hit)
    d = pool.allocate(1)
    out += [d, pool.available()]
    stats = pool.stats()
    out.append({k: stats[k] for k in ("pages", "free", "cached", "active")})
    return out


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_allocation_sequence_matches(prefix_cache):
    args = (2, 9, 4, 8)
    jp = jpc.PagePool(*args, name="j", prefix_cache=prefix_cache)
    tp = tpc.PagePool(*args, name="t", prefix_cache=prefix_cache, device="cpu")
    assert _script(tp, 4) == _script(jp, 4)


def test_write_and_locate_match():
    rng = np.random.RandomState(3)
    layers, pages, t, kv = 2, 6, 4, 8
    jp = jpc.PagePool(layers, pages, t, kv, name="jw")
    tp = tpc.PagePool(layers, pages, t, kv, name="tw", device="cpu")
    table = [4, 2, 5]
    where = [tp.locate(table, p) for p in (0, 3, 4, 9, 11)]
    assert where == [jp.locate(table, p) for p in (0, 3, 4, 9, 11)]
    k_new = rng.randn(layers, len(where), kv).astype(np.float32)
    v_new = rng.randn(layers, len(where), kv).astype(np.float32)
    pids, offs = [p for p, _ in where], [o for _, o in where]
    jp.write(jnp.asarray(k_new), jnp.asarray(v_new), pids, offs)
    tp.write(torch.from_numpy(k_new), torch.from_numpy(v_new), pids, offs)
    np.testing.assert_array_equal(tp.k.numpy(), jp.k.asnumpy())
    np.testing.assert_array_equal(tp.v.numpy(), jp.v.asnumpy())


def test_pool_checks():
    with pytest.raises(tpc.MXNetError):
        tpc.PagePool(1, 1, 4, 8, device="cpu")
    pool = tpc.PagePool(1, 3, 4, 8, device="cpu")
    with pytest.raises(tpc.MXNetError, match="exhausted"):
        pool.allocate(3)
