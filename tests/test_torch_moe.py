"""The MoE FFN (``mxnet_tpu_torch/ops/moe.py``, ``gluon.contrib.nn.MoEFFN``)
against the JAX package's ``_moe_ffn`` and ``MoEFFN`` on the same
numpy-seeded tokens and weights: y, the load-balance term, the capacity
and its drops, and the gradients of every input, fp32 within 1e-5 (y and
the gradients, whose sums run in other orders) and 1e-6 (aux); unsharded,
with the experts over ``ep`` = 4 and with the tokens over ``dp`` = 2 x
``ep`` = 4 on the port's CPU positions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.contrib.nn import MoEFFN as JMoEFFN
from mxnet_tpu.ops import moe as jmoe
from mxnet_tpu.ops.registry import REGISTRY as JREG
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon.contrib.nn import MoEFFN
from mxnet_tpu_torch.ops import moe as tmoe
from mxnet_tpu_torch.parallel import collectives as C

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-5, atol=1e-5)
D, HID, E = 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, tokens=(2, 16)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*tokens, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32),
            rng.randn(E, D, HID).astype(np.float32) * 0.3,
            rng.randn(E, HID, D).astype(np.float32) * 0.3,
            rng.randn(*tokens, D).astype(np.float32))


def _mesh(name):
    axes = {"none": None, "ep4": {"ep": 4}, "dp2xep4": {"dp": 2, "ep": 4}}
    return None if axes[name] is None else tpar.DeviceMesh(axes[name],
                                                           devices=CPU8)


@pytest.mark.parametrize("mesh", ["none", "ep4", "dp2xep4"])
@pytest.mark.parametrize("top_k,factor", [(2, 1.25), (1, 1.0), (2, 2.0)])
def test_moe_ffn_and_gradients_match_jax(top_k, factor, mesh):
    x, g, w1, w2, dy = _inputs(top_k + int(4 * factor))
    jf = JREG["_moe_ffn"].fn

    def jloss(*a):
        y, aux = jf(*a, top_k=top_k, capacity_factor=factor)
        return (y * dy).sum() + 3.0 * aux, (y, aux)
    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a) for a in (x, g, w1, w2)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, g, w1, w2)]
    C.reset_collective_counts()
    y, aux = tmoe._moe_ffn(*ts, top_k=top_k, capacity_factor=factor,
                           mesh=_mesh(mesh))
    assert C.collective_counts()["all_to_all"] == (0 if mesh == "none"
                                                   else 2)
    ((y * torch.tensor(dy)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for t, jgrad in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **TOL)


def test_capacity_and_drops_match_jax():
    """The capacity is the JAX package's, and so is which token goes to
    which slot of which expert: top-2 over 4 experts at factor 1.25 drops
    assignments (2T of them for E·C = 1.25T slots)."""
    for t, e, f in [(32, 4, 1.25), (7, 3, 1.0), (1, 8, 0.5), (100, 6, 2.0)]:
        assert tmoe.moe_capacity(t, e, f) == jmoe.moe_capacity(t, e, f)
    rng = np.random.RandomState(3)
    probs = rng.rand(32, 4).astype(np.float32)
    probs[5] = probs[6]          # a tie between two tokens
    probs[7, 1] = probs[7, 2]    # a tie inside one token's row
    probs /= probs.sum(-1, keepdims=True)
    cap = tmoe.moe_capacity(32, 4, 1.25)
    jd, jc, ja = jax.jit(jmoe._dispatch_combine, static_argnums=(1, 2))(
        jnp.asarray(probs), 2, cap)
    td, tc, ta = tmoe._dispatch_combine(torch.tensor(probs), 2, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert td.sum() < 2 * 32   # some assignments were dropped
    assert td.sum(dim=0).max() <= 1   # one token per slot


def test_moe_ffn_block_matches_jax():
    """``MoEFFN`` with the JAX block's weights (``params_from_mxnet``):
    the same parameter names and ``(y, aux)``; its weights' gradients are
    the functional op's (held to JAX's above)."""
    jnet = JMoEFFN(D, HID, num_experts=E, top_k=2, prefix="moe_")
    # numpy weights (the JAX initializer's random draws compile slowly)
    jnet.collect_params().initialize(init=jmx.init.Zero())
    rng = np.random.RandomState(5)
    for p in jnet.collect_params().values():
        p.set_data(jmx.nd.array(rng.uniform(-0.3, 0.3, p.shape)
                                .astype(np.float32)))
    tnet = MoEFFN(D, HID, num_experts=E, top_k=2, prefix="moe_",
                  device="cpu")
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    assert sorted(params) == sorted(tnet.collect_params().keys())
    params_from_mxnet(params, tnet)
    x, *_ = _inputs(11, tokens=(3, 8))
    jnet.hybridize()   # one compiled forward, not an op-by-op one
    jy, jaux = jnet(jmx.nd.array(x))
    ty, taux = tnet(torch.tensor(x))
    (ty.sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux.asnumpy()),
                               rtol=1e-6)
    ws = [torch.tensor(params["moe_" + n], requires_grad=True)
          for n in ("router_weight", "expert_w1", "expert_w2")]
    y, aux = tmoe._moe_ffn(torch.tensor(x), *ws, top_k=2)
    (y.sum() + aux).backward()
    for (name, t), w in zip(tnet.named_parameters(), ws):
        assert torch.equal(t.grad, w.grad), name
    with pytest.raises(ValueError):
        MoEFFN(D, HID, num_experts=2, top_k=3, device="cpu")


def test_registry_op_and_errors():
    x, g, w1, w2, _ = _inputs(2)
    prev = tmx.set_default_context(tmx.cpu())
    try:
        y, aux = tmx.nd._moe_ffn(*(tmx.nd.array(a) for a in (x, g, w1, w2)),
                                 top_k=2)
    finally:
        tmx.set_default_context(prev)
    ref, raux = tmoe._moe_ffn(*(torch.tensor(a) for a in (x, g, w1, w2)))
    assert np.array_equal(y.asnumpy(), ref.numpy())
    with pytest.raises(ValueError, match="num_experts"):
        tmoe._moe_ffn(*(torch.tensor(a) for a in (x, g, w1, w2)),
                      num_experts=3)
    # an expert spec that leaves ep out runs every expert where it is
    mesh = _mesh("ep4")
    with tpar.mesh.param_layouts({id(t): tpar.PartitionSpec()
                                  for t in ()}), mesh:
        C.reset_collective_counts()
        tmoe._moe_ffn(*(torch.tensor(a) for a in (x, g, w1, w2)))
        assert C.collective_counts()["all_to_all"] == 2
    w1t = torch.tensor(w1)
    with tpar.mesh.param_layouts({id(w1t): tpar.PartitionSpec()}):
        C.reset_collective_counts()
        tmoe._moe_ffn(torch.tensor(x), torch.tensor(g), w1t,
                      torch.tensor(w2), mesh=mesh)
        assert C.collective_counts()["all_to_all"] == 0
