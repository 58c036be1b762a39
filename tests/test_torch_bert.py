"""Port parity: the BERT pretraining slice against mxnet_tpu's, on CPU
tensors.

The ops BERT adds (LayerNorm, Embedding, gelu, tanh, FullyConnected on
mixed dtypes, Dropout), then the small BERT of ``bench.py:168-170`` (vocab
1000, units 64, hidden 128, 2 layers, 4 heads, seq 32, batch 8, dropout 0,
``token_types`` zeros) through two ``CompiledTrainStep`` steps with
``Adam(lr=1e-4)``, in fp32 and in bf16 through ``amp.convert_block``.  The
JAX model draws its weights; ``bert_state_dict_from_mxnet`` carries them
into the port.  Tokens and labels come from a numpy seed.  Random streams
differ between the packages, so dropout is off in every comparison.

Tolerances, each against the reference's value:

- ops in fp32: 1e-5 of each tensor's largest |value| (the same
  arithmetic, reduced in other orders);
- bf16 values: 2^-7 of the largest |value|, one bf16 ulp at the top
  binade (each package rounds to bf16 after fp32 sums taken in other
  orders, so a rounding may go the other way);
- the step's losses: 1e-5 relative in fp32.  In bf16 the first loss
  agrees to 1e-5 and the second within 1e-3: after one Adam step some
  bf16 weights differ in their last bit (measured 9.9e-5);
- the step-1 gradients, taken eagerly: 1e-4 of each tensor's largest
  |value| in fp32, 2^-6 (two bf16 ulps) in bf16, where every gradient of a
  bf16 weight is rounded to bf16 after sums in other orders (measured
  one ulp);
- the parameters after step 2: 2·lr per step, absolute.  Adam's first
  step moves each weight by about ±lr whatever the size of its gradient,
  so a gradient near zero whose sign the two packages round apart costs
  2·lr.  bf16 adds one bf16 ulp of the tensor's largest |value|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import autograd, nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.language import BERTForPretraining as JaxBert
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.contrib.amp import convert_block
from mxnet_tpu_torch.convert import _bert_name, bert_state_dict_from_mxnet
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.language import (BERTForPretraining,
                                                      BERTModel,
                                                      bert_12_768_12,
                                                      bert_24_1024_16)
from mxnet_tpu_torch.gluon.nn import Dense, Dropout
from mxnet_tpu_torch.ops import nn as tops

REL = 1e-5
BF16_REL = 2.0 ** -7
LOSS_REL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-3)}
GRAD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
LR, STEPS = 1e-4, 2
SMALL = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
             max_length=32, dropout=0.0)
VOCAB, BATCH, SEQ = 1000, 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "asnumpy"):
        return t.astype("float32").asnumpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, ref, rel, what, atol=0.0):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + atol
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _both(jfn, tfn, args, dtypes, cot):
    """``(ref_out, ref_grads, out, grads)``: ``jfn`` under ``jax.vjp`` and
    ``tfn`` under torch autograd, on ``args`` (fp32 numpy) cast to
    ``dtypes``, with the cotangent ``cot``."""
    jargs = [jnp.asarray(a).astype(d) for a, d in zip(args, dtypes)]
    ref, vjp = jax.vjp(jfn, *jargs)
    ref_grads = vjp(jnp.asarray(cot).astype(ref.dtype))
    leaves = [torch.from_numpy(a).to(getattr(torch, d)).requires_grad_()
              for a, d in zip(args, dtypes)]
    out = tfn(*leaves)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    return ref, ref_grads, out, [t.grad for t in leaves]


def _check(ref, ref_grads, out, grads, rel, names):
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    for name, g, r in zip(names, (out,) + tuple(grads),
                          (ref,) + tuple(ref_grads)):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        _close(g, r, rel, name)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """fp32 moments; the normalised value in x's dtype; then gamma and
    beta (fp32) with promotion, so a bf16 x gives an fp32 output in both
    packages.  Output and the gradients of x, gamma and beta."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 7, 16) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.randn(16).astype(np.float32)
    cot = rng.randn(4, 7, 16).astype(np.float32)
    res = _both(lambda a, g, b: jops._layer_norm(a, g, b, -1, 1e-12)[0],
                lambda a, g, b: tops.layer_norm(a, g, b, -1, 1e-12),
                (x, gamma, beta), (dtype, "float32", "float32"), cot)
    assert res[2].dtype == torch.float32
    _check(*res, REL if dtype == "float32" else BF16_REL,
           ("out", "dx", "dgamma", "dbeta"))


@pytest.mark.parametrize("act", ["gelu", "tanh"])
def test_activation_matches_jax(act):
    """gelu is the exact erf form, jax.nn.gelu(approximate=False)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 40) * 3).astype(np.float32)
    cot = rng.randn(6, 40).astype(np.float32)
    res = _both(lambda a: jops._activation(a, act),
                lambda a: tops.activation(a, act), (x,), ("float32",), cot)
    _check(*res, REL, ("out", "dx"))


@pytest.mark.parametrize("bias", [True, False])
def test_fully_connected_promotes_mixed_operands_like_jax(bias):
    """An fp32 activation against a bf16 weight and bias (amp): the
    product runs in fp32 in both packages; the weight's and bias's
    gradients come back in bf16."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 3, 8).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (6, 8)).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    cot = rng.randn(5, 3, 6).astype(np.float32)
    args, dtypes = (x, w), ("float32", "bfloat16")
    if bias:
        args, dtypes = args + (b,), dtypes + ("bfloat16",)

    def jfn(*a):
        return jops._fully_connected(a, num_hidden=6, no_bias=not bias,
                                     flatten=False)

    def tfn(*a):
        return tops.fully_connected(a[0], a[1], a[2] if bias else None,
                                    flatten=False)
    res = _both(jfn, tfn, args, dtypes, cot)
    assert res[2].dtype == torch.float32
    _check(*res, BF16_REL, ("out", "dx", "dw", "db")[:len(args) + 1])


def test_embedding_and_its_scatter_add_gradient_match_jax():
    """Rows gathered by int indices, with repeats; the weight's gradient
    sums the rows' cotangents (the JAX op's registered dense gradient,
    through mx.autograd)."""
    rng = np.random.RandomState(3)
    w = rng.randn(10, 6).astype(np.float32)
    idx = np.array([[1, 4, 1, 9], [4, 4, 0, 1]], np.int32)
    cot = rng.randn(2, 4, 6).astype(np.float32)
    jw = nd.array(w)
    jw.attach_grad()
    with autograd.record():
        ref = nd.Embedding(nd.array(idx), jw, input_dim=10, output_dim=6)
    ref.backward(nd.array(cot))
    tw = torch.from_numpy(w).requires_grad_()
    out = tops.embedding(torch.from_numpy(idx), tw)
    out.backward(torch.from_numpy(cot))
    _close(out, ref, REL, "out")
    _close(tw.grad, jw.grad, REL, "dweight")
    assert float(tw.grad[4].abs().sum()) > 0 and float(
        tw.grad[2].abs().sum()) == 0


def test_dropout_draws_from_its_generator():
    """No reference comparison (the streams differ): the keep mask is
    Bernoulli(1 − p) from the generator given, kept values are scaled by
    1/(1 − p) and so is their gradient; evaluation, p = 0 and a missing
    generator in evaluation are the identity; training without one
    raises."""
    x = torch.ones(200, 500, requires_grad=True)
    layer = Dropout(0.1, generator=torch.Generator().manual_seed(5))
    y = layer(x)
    y.sum().backward()
    kept = y.detach() != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.allclose(y.detach()[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(x.grad, y.detach())
    again = Dropout(0.1, generator=torch.Generator().manual_seed(5))(x)
    assert torch.equal(again, y)
    assert Dropout(0.1).eval()(x) is x
    assert Dropout(0.0)(x) is x
    with pytest.raises(MXNetError):
        Dropout(0.1)(x)
    assert tops.dropout(x, 0.5, training=True, generator=torch.Generator(),
                        axes=(1,)).eq(0).all(dim=1).sum() > 0


@pytest.mark.parametrize("act", [None, "gelu", "tanh"])
def test_dense_activation_matches_jax(act):
    from mxnet_tpu.gluon import nn as jnn
    rng = np.random.RandomState(4)
    jlayer = jnn.Dense(5, activation=act, flatten=False, in_units=7)
    jlayer.collect_params().initialize()
    tlayer = Dense(5, activation=act, flatten=False, in_units=7,
                   device="cpu")
    for p, t in zip(jlayer.collect_params().values(),
                    tlayer.state_dict().values()):
        v = rng.randn(*t.shape).astype(np.float32)
        p.set_data(nd.array(v))
        t.copy_(torch.from_numpy(v))
    x = rng.randn(3, 2, 7).astype(np.float32)
    _close(tlayer(torch.from_numpy(x)), jlayer(nd.array(x)), REL, act)


# ---------------------------------------------------------------------------
# the slice: small BERT, two Adam steps
# ---------------------------------------------------------------------------
def _jax_params(jnet):
    return {k: p.data().astype("float32").asnumpy()
            for k, p in jnet.collect_params().items()}


def _pair(dtype, **cfg):
    """(JAX BERTForPretraining, port BERTForPretraining) with the JAX
    model's initial weights, converted to ``dtype`` when it is bf16."""
    cfg = {**SMALL, **cfg}
    jnet = JaxBert(vocab_size=VOCAB, **cfg)
    jnet.collect_params().initialize()
    if dtype != "float32":
        jamp.convert_block(jnet, target_dtype=dtype)
    tnet = BERTForPretraining(vocab_size=VOCAB, device="cpu", **cfg)
    bert_state_dict_from_mxnet(_jax_params(jnet), tnet)
    if dtype != "float32":
        convert_block(tnet, dtype)
    return jnet, tnet


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    return tokens, np.zeros((BATCH, SEQ), np.int32), labels


def _mlm_losses():
    jce, tce = jloss.SoftmaxCrossEntropyLoss(), SoftmaxCrossEntropyLoss()

    def jfn(out, y):
        return jce(out[0].reshape((-1, VOCAB)), y.reshape((-1,)))

    def tfn(out, y):
        return tce(out[0].reshape(-1, VOCAB), y.reshape(-1))
    return jfn, tfn


def _names(jnet):
    keys = list(jnet.collect_params())
    top = [k for k in keys if k.endswith("mlm_bias")][0][: -len("mlm_bias")]
    backbone = [k for k in keys if k.endswith("word_embed_weight")][0][
        : -len("word_embed_weight")]
    return lambda key: _bert_name(key, top, backbone)


_RUNS = {}


def _run(dtype):
    """Forward outputs, eager step-1 gradients, the two steps' losses and
    the parameters after them, in both packages (once per dtype)."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    jnet, tnet = _pair(dtype)
    name_of = _names(jnet)
    tokens, types, labels = _batch()
    jx = (nd.array(tokens), nd.array(types))
    tx = (torch.from_numpy(tokens), torch.from_numpy(types))
    jy, ty = nd.array(labels), torch.from_numpy(labels)
    jloss_fn, tloss_fn = _mlm_losses()
    r = {"name_of": name_of, "init": dict(_jax_params(jnet))}
    r["jout"] = [o.astype("float32").asnumpy() for o in jnet(*jx)]
    r["jdtypes"] = [str(o.dtype) for o in jnet(*jx)]
    with torch.no_grad():
        tout = tnet(*tx)
    r["tout"], r["tdtypes"] = tout, [str(o.dtype).split(".")[-1]
                                     for o in tout]
    with autograd.record():
        loss = jloss_fn(jnet(*jx), jy).mean()
    loss.backward()
    r["jgrads"] = {k: p.grad().astype("float32").asnumpy()
                   for k, p in jnet.collect_params().items()}
    tnet.train()
    tloss_fn(tnet(*tx), ty).mean().backward()
    r["tgrads"] = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for k, p in tnet.named_parameters()}
    r["tgrad_none"] = {k for k, p in tnet.named_parameters() if p.grad is None}
    for p in tnet.parameters():
        p.grad = None
    jstep = JaxTrainStep(jnet, jloss_fn, jopt.create("adam", learning_rate=LR),
                         batch_size=BATCH)
    tstep = CompiledTrainStep(tnet, tloss_fn,
                              topt.create("adam", learning_rate=LR),
                              batch_size=BATCH)
    r["jloss"], r["tloss"], r["jparams"], r["tparams"] = [], [], [], []
    for _ in range(STEPS):
        r["jloss"].append(float(jstep(jx, jy).asnumpy()))
        r["tloss"].append(tstep(tx, ty).item())
        r["jparams"].append(_jax_params(jnet))
        r["tparams"].append({k: v.detach().clone()
                             for k, v in tnet.state_dict().items()})
    r["tokens"] = tokens
    _RUNS[dtype] = r
    return r


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bert_forward_outputs_and_dtypes_match_jax(dtype):
    """fp32 mlm and nsp in both runs: under amp, LayerNorm's fp32 gamma
    promotes every activation from embed_ln on."""
    r = _run(dtype)
    assert r["tdtypes"] == r["jdtypes"] == ["float32", "float32"]
    for name, got, ref in zip(("mlm", "nsp"), r["tout"], r["jout"]):
        _close(got, ref, REL, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bert_step1_gradients_match_jax(dtype):
    """Every gradient of the first step, including the tied embedding
    (lookup plus decoder) and the pooler and NSP head, which the MLM loss
    does not reach (None in torch, zero in JAX)."""
    r = _run(dtype)
    assert r["tgrad_none"] == {"bert.pooler.weight", "bert.pooler.bias",
                               "nsp.weight", "nsp.bias"}
    for key, g in r["tgrads"].items():
        ref = r["jgrads"][r["name_of"](key)]
        if key in r["tgrad_none"]:
            assert not ref.any(), key
            continue
        _close(g, ref, GRAD_REL[dtype], key)


def test_tied_decoder_gradient_reaches_the_embedding():
    """The rows of word_embed.weight that the batch never looks up get
    their gradient from the MLM decoder alone: nonzero and equal to the
    reference's in the eager gradient, and both packages' steps move them
    by about lr (Adam's first step), so each compiled step passes the
    decoder's gradient to the embedding."""
    r = _run("float32")
    key = "bert.word_embed.weight"
    unseen = np.setdiff1d(np.arange(VOCAB), r["tokens"])
    assert len(unseen) > 500
    g = _np(r["tgrads"][key])[unseen]
    ref = r["jgrads"][r["name_of"](key)][unseen]
    assert np.abs(ref).min() > 0 and np.abs(g).min() > 0
    _close(g, ref, GRAD_REL["float32"], "unseen rows")
    w0 = r["init"][r["name_of"](key)][unseen]
    for params in (r["jparams"][0][r["name_of"](key)],
                   _np(r["tparams"][0][key])):
        moved = np.abs(params[unseen] - w0)
        # lr·|m|/(sqrt(v) + ε): below lr only where |g| nears ε
        assert moved.min() > 0 and np.median(moved) > 0.99 * LR
        assert moved.max() < 1.01 * LR


@pytest.mark.parametrize("dtype", DTYPES)
def test_bert_two_step_losses_match_jax(dtype):
    r = _run(dtype)
    for i, (got, ref) in enumerate(zip(r["tloss"], r["jloss"])):
        assert np.isfinite(got)
        assert abs(got - ref) <= LOSS_REL[dtype][i] * abs(ref), (i, got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bert_parameters_after_two_steps_match_jax(dtype):
    r = _run(dtype)
    last = r["jparams"][-1]
    for key, got in r["tparams"][-1].items():
        ref = last[r["name_of"](key)]
        rel = BF16_REL if got.dtype == torch.bfloat16 else 0.0
        _close(got, ref, rel, key, atol=2 * LR * STEPS)
        assert str(got.dtype).split(".")[-1] == (
            "float32" if key.endswith(("gamma", "beta")) else dtype)


def test_bert_valid_length_forward_matches_jax():
    """valid_length takes the masked dense attention in every layer."""
    jnet, tnet = _pair("float32")
    tokens, types, _ = _batch(1)
    valid = np.array([32, 5, 17, 1, 32, 9, 30, 2], np.int32)
    ref = jnet(nd.array(tokens), nd.array(types), nd.array(valid))
    with torch.no_grad():
        out = tnet(torch.from_numpy(tokens), torch.from_numpy(types),
                   torch.from_numpy(valid))
    for name, got, r in zip(("mlm", "nsp"), out, ref):
        _close(got, r, REL, name)


def test_convert_block_casts_bert_like_jax():
    """bf16: position_weight, mlm_bias, the embeddings and every Dense;
    every LayerNorm's gamma and beta stay fp32."""
    jnet, tnet = _pair("bfloat16")
    name_of = _names(jnet)
    ref = {k: str(p.data().dtype) for k, p in jnet.collect_params().items()}
    got = {name_of(k): str(v.dtype).split(".")[-1]
           for k, v in tnet.state_dict().items()}
    assert got == ref
    assert sorted(k for k, d in got.items() if d == "float32") == sorted(
        k for k in ref if k.endswith(("_gamma", "_beta")))


# ---------------------------------------------------------------------------
# weight transfer and model sizes
# ---------------------------------------------------------------------------
def test_bert_state_dict_round_trips_and_maps_the_tied_weight_once():
    jnet, tnet = _pair("float32", num_layers=1)
    params = _jax_params(jnet)
    state = tnet.state_dict()
    assert len(state) == len(params) == 26
    name_of = _names(jnet)
    for key, t in state.items():
        np.testing.assert_array_equal(t.numpy(), params[name_of(key)])
    assert [k for k in state if "word_embed" in k] == [
        "bert.word_embed.weight"]
    assert sum(1 for _ in tnet.parameters()) == len(state)


@pytest.mark.parametrize("bad", ["missing", "extra", "shape"])
def test_bert_state_dict_refuses_a_mismatch(bad):
    jnet, tnet = _pair("float32", num_layers=1)
    params = _jax_params(jnet)
    name = next(k for k in params if k.endswith("ln1_gamma"))
    if bad == "missing":
        del params[name]
    elif bad == "extra":
        params[name.replace("ln1", "ln3")] = params[name]
    else:
        params[name] = np.zeros(3, np.float32)
    with pytest.raises(MXNetError):
        bert_state_dict_from_mxnet(params, tnet)


@pytest.mark.parametrize("make,spec", [(bert_12_768_12, (12, 768, 3072)),
                                       (bert_24_1024_16, (24, 1024, 4096))])
def test_bert_sizes(make, spec):
    """The published sizes (vocab 30522, max_length 512), built on the
    meta device: embeddings and embed_ln, L layers (packed QKV, output,
    two FFN products, two LayerNorms) and the pooler."""
    layers, u, h = spec
    embed = 30522 * u + 2 * u + 512 * u + 2 * u
    layer = 3 * u * u + 3 * u + u * u + u + 2 * u + 2 * u * h + h + u + 2 * u
    net = make(device="meta")
    assert isinstance(net, BERTModel)
    assert sum(p.numel() for p in net.parameters()) == (
        embed + layers * layer + u * u + u)


def test_bert_entry_points_default_to_the_card(monkeypatch):
    """Without a card the BERT constructors raise instead of running on
    the host; ``device="cpu"`` is the caller's choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: BERTForPretraining(vocab_size=10, **SMALL),
                 lambda: bert_12_768_12()):
        with pytest.raises(MXNetError):
            make()
