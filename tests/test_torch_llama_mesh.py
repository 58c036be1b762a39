"""The sequence- and expert-parallel training path against the JAX package
on its 8 virtual CPU devices: ``LlamaModel``'s three attention modes and
its MoE output, ``CompiledTrainStep(mesh=...)`` on a dp, a dp x sp, a
dp x ep and a 3-D mesh (3 Adam steps of losses, then every parameter),
and the fused conv-BN block under a dp mesh.

Weights cross from the JAX models through ``convert.py``; the port's mesh
positions are CPU devices.  The JAX oracles are the JAX package's own
meshed steps: the dense model on ``{dp: 2}`` and the MoE model on
``{dp: 2, ep: 4}``, each computed once for the file; every port mesh is
held to the one its model matches (a mesh changes no result in either
package, up to rounding).  Tolerances, fp32: logits 1e-5, losses 1e-5
relative, parameters after 3 steps 1e-4 (Adam's first steps move each
weight by about lr, so rounding in the gradient's last bits shows in the
update's)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.executor import CompiledTrainStep as JStep
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jllama_tiny
from mxnet_tpu.parallel import DeviceMesh as JMesh

from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.convert import (_mxnet_suffix, _prefix_of,
                                     llama_state_dict_from_mxnet,
                                     params_from_mxnet)
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny
from mxnet_tpu_torch.parallel import collectives as C

CPU8 = [torch.device("cpu")] * 8
VOCAB, B, S = 64, 4, 8
KW = dict(vocab_size=VOCAB, num_layers=1, num_kv_heads=2, max_length=16)
LR, STEPS = 1e-3, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, VOCAB, (B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.float32)


def _jax_net(moe):
    """The JAX llama_tiny with numpy-seeded weights (uniform in ±0.07, the
    default initializer's range; its own draws compile slowly on the CPU)
    and its RoPE tables and norm scales as built."""
    net = jllama_tiny(**KW, **(dict(moe_experts=4, moe_top_k=2) if moe
                               else {}))
    net.collect_params().initialize(init=jmx.init.Zero())
    rng = np.random.RandomState(21)
    for name, p in net.collect_params().items():
        if p.grad_req != "null" and not name.endswith("norm_weight"):
            p.set_data(jmx.nd.array(rng.uniform(-0.07, 0.07, p.shape)
                                    .astype(np.float32)))
    return net


def _params(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _port_net(params, moe, attention="flash", mesh=None):
    tnet = llama_tiny(**KW, attention=attention, mesh=mesh, device="cpu",
                      **(dict(moe_experts=4, moe_top_k=2) if moe else {}))
    llama_state_dict_from_mxnet(params, tnet)
    return tnet


def _jax_loss(moe):
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, y):
        if moe:
            logits, aux = out
            return ce(logits.reshape((-1, VOCAB)), y.reshape((-1,))) \
                + 0.01 * aux
        return ce(out.reshape((-1, VOCAB)), y.reshape((-1,)))
    return loss


def _port_loss(moe):
    ce = tloss.SoftmaxCrossEntropyLoss()

    def loss(out, y):
        if moe:
            logits, aux = out
            return ce(logits.reshape(-1, VOCAB), y.reshape(-1)) + 0.01 * aux
        return ce(out.reshape(-1, VOCAB), y.reshape(-1))
    return loss


@pytest.fixture(scope="module")
def jax_runs():
    """For the dense and the MoE model: the initial weights, the logits
    (and aux) of the first batch, and the JAX meshed step's losses and
    final weights."""
    tokens, labels = _data()
    runs = {}
    for moe, axes in ((False, {"dp": 2}), (True, {"dp": 2, "ep": 4})):
        net = _jax_net(moe)
        x = jmx.nd.array(tokens)
        net.hybridize()   # one compiled forward, not an op-by-op one
        first = net(x)
        init = _params(net)
        outs = [o.asnumpy() for o in first] if moe else [first.asnumpy()]
        step = JStep(net, _jax_loss(moe), jopt.create("adam",
                                                      learning_rate=LR),
                     batch_size=B, mesh=JMesh(axes))
        losses = [float(step(x, jmx.nd.array(labels)).asnumpy())
                  for _ in range(STEPS)]
        runs[moe] = dict(init=init, outs=outs, losses=losses,
                         final=_params(net))
    return runs


@pytest.mark.parametrize("attention,axes", [
    ("flash", None), ("ring", {"sp": 4}), ("ulysses", {"sp": 4}),
    ("ring", {"dp": 2, "sp": 2})])
def test_attention_modes_match_jax_logits(jax_runs, attention, axes):
    tokens, _ = _data()
    mesh = None if axes is None else tpar.DeviceMesh(axes, devices=CPU8)
    tnet = _port_net(jax_runs[False]["init"], False, attention, mesh)
    with torch.no_grad():
        out = tnet(torch.tensor(tokens, dtype=torch.long))
    np.testing.assert_allclose(out.numpy(), jax_runs[False]["outs"][0],
                               rtol=1e-5, atol=1e-5)


def test_moe_model_returns_logits_and_mean_aux(jax_runs):
    tokens, _ = _data()
    tnet = _port_net(jax_runs[True]["init"], True)
    with torch.no_grad():
        logits, aux = tnet(torch.tensor(tokens, dtype=torch.long))
    jlogits, jaux = jax_runs[True]["outs"]
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    with pytest.raises(ValueError, match="MoE"):
        tnet.cache_forward(*[None] * 6)


# (model is MoE, attention, mesh axes, the collective the mesh must move)
STEP_MESHES = {
    "dp": (False, "flash", {"dp": 2}, "pmean"),
    "dp_x_sp": (False, "ring", {"dp": 2, "sp": 4}, "ppermute"),
    "dp_x_ep": (True, "flash", {"dp": 2, "ep": 4}, "all_to_all"),
    "dp_x_sp_x_ep": (True, "ring", {"dp": 2, "ep": 2, "sp": 2}, "all_to_all"),
}


@pytest.mark.parametrize("name", sorted(STEP_MESHES))
def test_compiled_train_step_on_mesh_matches_jax(jax_runs, name):
    moe, attention, axes, moved = STEP_MESHES[name]
    ref = jax_runs[moe]
    tokens, labels = _data()
    mesh = tpar.DeviceMesh(axes, devices=CPU8)
    tnet = _port_net(ref["init"], moe, attention)
    step = CompiledTrainStep(tnet, _port_loss(moe),
                             topt.create("adam", learning_rate=LR),
                             batch_size=B, mesh=mesh)
    assert step.grad_bucket_count < len(step._learnable)  # fused by default
    C.reset_collective_counts()
    losses = [float(step(torch.tensor(tokens, dtype=torch.long),
                         torch.tensor(labels))) for _ in range(STEPS)]
    assert C.collective_counts()[moved] > 0
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    prefix = _prefix_of(ref["final"], "tok_embed_weight")
    for key, t in tnet.state_dict().items():
        np.testing.assert_allclose(
            t.numpy(), ref["final"][prefix + _mxnet_suffix(key)], rtol=1e-4,
            atol=1e-4, err_msg=key)
    if moe:
        assert tuple(step.param_specs["layers.0.ffn.expert_w1"]) == ("ep",)


def test_fused_conv_bn_block_under_dp_mesh():
    """The fused 1x1 conv + BN block under a dp = 4 step: each dp position
    runs the op on its rows and the statistics are psum'd, and 3 SGD steps
    give the JAX package's dp = 4 losses."""
    from mxnet_tpu.gluon.contrib.nn import FusedConv1x1BN as JFused
    from mxnet_tpu_torch.gluon import nn as tnn
    from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN

    def jbuild():
        jmx.random.seed(11)
        net = jgluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(JFused(16, in_channels=8, relu=True, prefix="fused_"))
            net.add(jgluon.nn.GlobalAvgPool2D())
            net.add(jgluon.nn.Dense(4, in_units=16, prefix="fc_"))
        net.collect_params().initialize()
        return net

    rng = np.random.RandomState(12)
    x = rng.randn(16, 8, 6, 6).astype(np.float32)
    y = rng.randint(0, 4, (16,)).astype(np.float32)
    jnet = jbuild()
    params = _params(jnet)
    jstep = JStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                  jopt.create("sgd", learning_rate=0.05), batch_size=16,
                  mesh=JMesh({"dp": 4}))
    jlosses = [float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
               for _ in range(STEPS)]

    tnet = tnn.HybridSequential(prefix="net_")
    with tnet.name_scope():
        tnet.add(FusedConv1x1BN(16, in_channels=8, relu=True,
                                prefix="fused_", device="cpu"))
        tnet.add(tnn.GlobalAvgPool2D())
        tnet.add(tnn.Dense(4, in_units=16, prefix="fc_", device="cpu"))
    tnet.initialize()
    params_from_mxnet(params, tnet)
    step = CompiledTrainStep(tnet, tloss.SoftmaxCrossEntropyLoss(),
                             topt.create("sgd", learning_rate=0.05),
                             batch_size=16,
                             mesh=tpar.DeviceMesh({"dp": 4}, devices=CPU8))
    C.reset_collective_counts()
    losses = [float(step(torch.tensor(x), torch.tensor(y)))
              for _ in range(STEPS)]
    # per step: the two statistics' psums, and the loss's pmean
    assert C.collective_counts()["psum"] == 2 * STEPS
    assert C.collective_counts()["pmean"] == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
