"""The port's sharding rules and pipeline (``mxnet_tpu_torch/parallel/
rules.py``, ``pipeline.py``) against the JAX package's.

Rules: every parameter of llama_tiny, of a MoE llama_tiny and of a small
BERT gets, from the port's dotted name, the spec the JAX package's rules
give its counterpart (the pairing of names is ``convert.py``'s), on
several meshes and both rule tables.  Pipeline: SPMD GPipe at pp = 2 and
pp = 4 on the port's CPU positions, its output and its gradients held to
the JAX package's ``spmd_pipeline`` on the same numpy-seeded stages
within 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.gluon.model_zoo.language import (BERTForPretraining as JBert,
                                                llama_tiny as jllama_tiny)
from mxnet_tpu.parallel import DeviceMesh as JMesh
from mxnet_tpu.parallel import pipeline as jpipe
from mxnet_tpu.parallel import rules as jrules

from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.convert import _bert_name, _mxnet_suffix, _prefix_of
from mxnet_tpu_torch.gluon.model_zoo.language import (BERTForPretraining,
                                                      llama_tiny)
from mxnet_tpu_torch.parallel import pipeline as tpipe
from mxnet_tpu_torch.parallel import rules as trules

CPU8 = [torch.device("cpu")] * 8
MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 2, "ep": 4},
          {"fsdp": 4, "tp": 2}, {"sp": 4}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama(moe):
    kw = dict(moe_experts=4, moe_top_k=2) if moe else {}
    jnet = jllama_tiny(vocab_size=64, **kw)
    tnet = llama_tiny(vocab_size=64, device="cpu", **kw)
    names = list(jnet.collect_params().keys())
    prefix = _prefix_of(names, "tok_embed_weight")
    return jnet, tnet, lambda key: prefix + _mxnet_suffix(key)


def _bert():
    cfg = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
               max_length=16, dropout=0.0)
    jnet = JBert(vocab_size=100, **cfg)
    tnet = BERTForPretraining(vocab_size=100, device="cpu", **cfg)
    names = list(jnet.collect_params().keys())
    top = _prefix_of(names, "mlm_bias")
    backbone = _prefix_of(names, "word_embed_weight")
    return jnet, tnet, lambda key: _bert_name(key, top, backbone)


MODELS = {"llama_tiny": lambda: _llama(False),
          "llama_tiny_moe": lambda: _llama(True), "bert": _bert}


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("table", ["default", "llama"])
def test_every_parameter_gets_the_jax_spec(model, table):
    jnet, tnet, jax_name = MODELS[model]()
    jparams = jnet.collect_params()
    rules_j = None if table == "default" else jrules.LLAMA_RULES
    rules_t = None if table == "default" else trules.LLAMA_RULES
    named = list(tnet.named_parameters())
    assert named
    for axes in MESHES:
        fn = tpar.auto_param_spec_fn(tpar.DeviceMesh(axes, devices=CPU8),
                                     rules_t)
        for key, t in named:
            name = jax_name(key)
            assert name in jparams, (key, name)
            known = jparams[name].shape
            if known and all(known):
                assert tuple(known) == tuple(t.shape), name
            want = jrules.spec_for(name, tuple(t.shape), axes, rules_j)
            assert _as_tuple(fn(key, t)) == _as_tuple(want), (axes, key)
    if model == "llama_tiny_moe":
        mesh = tpar.DeviceMesh({"dp": 2, "ep": 4}, devices=CPU8)
        spec = tpar.auto_param_spec_fn(mesh)(
            "layers.0.ffn.expert_w1", tnet.layers[0].ffn.expert_w1)
        assert tuple(spec) == ("ep",)


def test_rule_tables_and_divisibility_match_jax():
    assert [(r.pattern.pattern, r.spec, r.ndim) for r in trules.LLAMA_RULES] \
        == [(r.pattern.pattern, r.spec, r.ndim) for r in jrules.LLAMA_RULES]
    axes = {"tp": 4, "fsdp": 2, "dp": 2}
    for spec, shape in [(("tp", "fsdp"), (6, 8)), ((("tp", "fsdp"), None),
                                                   (16, 3)),
                        (("fsdp", None, None, None), (3, 4, 1, 1)),
                        ((None, "tp"), (5, 12))]:
        assert _as_tuple(trules._divisible(spec, shape, axes)) == \
            _as_tuple(jrules._divisible(spec, shape, axes))
    # an unmatched parameter takes fsdp over its largest dividing dim
    for shape in [(6, 4), (4, 6), (3, 5), (8,)]:
        assert _as_tuple(trules.spec_for("zz", shape, {"fsdp": 2})) == \
            _as_tuple(jrules.spec_for("zz", shape, {"fsdp": 2}))


def test_describe_sharding_lists_every_parameter():
    _, tnet, _ = _llama(True)
    text = tpar.describe_sharding(
        tnet, tpar.DeviceMesh({"dp": 2, "ep": 4}, devices=CPU8))
    assert len(text.splitlines()) == len(list(tnet.parameters()))
    assert "layers.1.ffn.expert_w2" in text


# ------------------------------------------------------------ pipeline
def _stage_params(rng, d, hidden):
    return (rng.randn(d, hidden).astype(np.float32) * 0.1,
            rng.randn(hidden).astype(np.float32) * 0.1,
            rng.randn(hidden, d).astype(np.float32) * 0.1,
            rng.randn(d).astype(np.float32) * 0.1)


def _jstage(params, h):
    w1, b1, w2, b2 = params
    return jax.nn.relu(h @ w1 + b1) @ w2 + b2


def _tstage(params, h):
    w1, b1, w2, b2 = params
    return torch.relu(h @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_output_and_gradients_match_jax(pp, n_micro):
    rng = np.random.RandomState(pp + n_micro)
    d, hidden, batch = 4, 8, 8
    stages = [_stage_params(rng, d, hidden) for _ in range(pp)]
    x = rng.randn(batch, d).astype(np.float32)
    dy = rng.randn(batch, d).astype(np.float32)

    jm = JMesh({"pp": pp})
    jstacked = jpipe.stack_stage_params(
        [tuple(jnp.asarray(a) for a in s) for s in stages])

    def jloss(params, xx):
        out = jpipe.spmd_pipeline(_jstage, params, xx, jm,
                                  n_microbatches=n_micro)
        return (out * dy).sum(), out
    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jstacked, jnp.asarray(x))

    tm = tpar.DeviceMesh({"pp": pp}, devices=CPU8)
    tstacked = tpipe.stack_stage_params(
        [tuple(torch.tensor(a) for a in s) for s in stages])
    tstacked = tuple(t.requires_grad_(True) for t in tstacked)
    tx = torch.tensor(x, requires_grad=True)
    tout = tpipe.spmd_pipeline(_tstage, tstacked, tx, tm,
                               n_microbatches=n_micro)
    (tout * torch.tensor(dy)).sum().backward()
    # the sequential stages are the oracle of both
    ref = x
    for s in stages:
        ref = np.maximum(ref @ s[0] + s[1], 0) @ s[2] + s[3]
    np.testing.assert_allclose(tout.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for t, g in zip(tstacked, jgp):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        tpipe.spmd_pipeline(_tstage, tstacked, tx[:3], tm,
                            n_microbatches=n_micro)


def test_pipeline_stage_calls_its_function():
    stage = tpar.PipelineStage(lambda p, h: h * p, 3.0)
    assert float(stage(torch.tensor(2.0))) == 6.0
