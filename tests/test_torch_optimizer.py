"""Port parity: the SGD and Adam update ops, the SGD and Adam optimizers,
bf16 conversion and the training step's optimizer handling, against
mxnet_tpu's.

Inputs are seeded numpy arrays fed to both packages.  Tolerance: fp32
updates within 1e-6 of the largest |value| (the same elementwise
arithmetic in the same order; XLA may contract a multiply-add that
PyTorch rounds twice).  bf16 Adam updates within one bf16 ulp of each
reference element: both packages take the Python scalars in bf16 and
round each op to bf16 (the eager ops here agree bit for bit), but XLA
may keep excess precision inside a fusion (jitted, the compiled step's
form differed in 0.1% of 200k elements by one ulp).  The training step is held to the closed-form gradient of its
mean loss within 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.contrib.amp import convert_block
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon.nn import BatchNorm, Conv2D, Dense, HybridSequential
from mxnet_tpu_torch.ops import optimizer_ops as tops

REL = 1e-6


def _close(got, ref, what=""):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    bound = REL * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _arrays(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(6, 5).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_sgd_mom_update_matches_jax(clip):
    w, g, m = _arrays(0)
    kw = dict(lr=0.1, momentum=0.9, wd=1e-2, rescale_grad=0.25,
              clip_gradient=clip)
    ref_w, ref_m = jops._sgd_mom_update(w, g, m, **kw)
    tw, tm = torch.tensor(w), torch.tensor(m)
    tops.sgd_mom_update(tw, torch.tensor(g), tm, **kw)
    _close(tw, ref_w, "weight")
    _close(tm, ref_m, "momentum")


def test_sgd_update_matches_jax():
    w, g = _arrays(1, 2)
    kw = dict(lr=0.05, wd=1e-3, rescale_grad=2.0, clip_gradient=0.3)
    ref = jops._sgd_update(w, g, **kw)
    tw = torch.tensor(w)
    tops.sgd_update(tw, torch.tensor(g), **kw)
    _close(tw, ref, "weight")


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_sgd_optimizer_matches_jax(momentum):
    """Three updates of two parameters through ``Optimizer.update`` with
    per-name lr multipliers and the default wd exemption of biases."""
    names = {0: "dense0_weight", 1: "dense0_bias"}
    kw = dict(learning_rate=0.2, momentum=momentum, wd=1e-2,
              rescale_grad=0.5, clip_gradient=2.0, param_idx2name=names)
    jo, to = jopt.create("sgd", **kw), topt.create("sgd", **kw)
    for o in (jo, to):
        o.set_lr_mult({"dense0_bias": 2.0})
        o.set_wd_mult({})
    ws = _arrays(2, 2)
    jw = [nd.array(w) for w in ws]
    tw = [torch.tensor(w) for w in ws]
    jst = [jo.create_state(i, w) for i, w in enumerate(jw)]
    tst = [to.create_state(i, w) for i, w in enumerate(tw)]
    for step in range(3):
        grads = _arrays(10 + step, 2)
        for i in range(2):
            jo.update(i, jw[i], nd.array(grads[i]), jst[i])
            to.update(i, tw[i], torch.tensor(grads[i]), tst[i])
    for i in range(2):
        _close(tw[i], jw[i].asnumpy(), f"weight {i}")
        if momentum:
            _close(tst[i], jst[i].asnumpy(), f"momentum {i}")
        else:
            assert tst[i] is None and jst[i] is None


def _bf16_ulp(ref):
    """The spacing of bf16 numbers at each element of ``ref`` (8 bits of
    mantissa); 0 at 0."""
    ref = np.abs(np.asarray(ref, np.float32))
    with np.errstate(divide="ignore"):
        e = np.floor(np.log2(np.where(ref > 0, ref, 1.0)))
    return np.where(ref > 0, 2.0 ** (e - 7), 0.0)


def _adam_close(got, ref, dtype, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref.astype("float32") if hasattr(ref, "astype")
                     else ref, np.float32)
    if dtype == "float32":
        _close(torch.from_numpy(got), ref, what)
        return
    err = np.abs(got - ref) - _bf16_ulp(ref)
    assert err.max() <= 0, f"{what}: {int((err > 0).sum())} elements off " \
                           f"by more than one bf16 ulp"


def _adam_arrays(seed, dtype):
    """A weight ~ U(-0.07, 0.07), as the initializer draws it, and three
    gradients of magnitude ~1e-3, in ``dtype``."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(-0.07, 0.07, (64, 33)).astype(np.float32)
    grads = [(rng.randn(64, 33) * 1e-3).astype(np.float32) for _ in range(3)]
    to = lambda a: torch.tensor(a).to(getattr(torch, dtype))
    return w, grads, to


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_op_matches_jax_compiled_form(dtype, wd):
    """The op as the JAX compiled step runs it: lr a float32 array."""
    import jax.numpy as jnp
    w, grads, to = _adam_arrays(3, dtype)
    jw = jnp.asarray(w).astype(dtype)
    jm = jv = jnp.zeros_like(jw)
    tw, tm, tv = to(w), to(0 * w), to(0 * w)
    for t, g in enumerate(grads, start=1):
        lr = 1e-3 * (1 - 0.999 ** t) ** 0.5 / (1 - 0.9 ** t)
        jw, jm, jv = jops._adam_update(jw, jnp.asarray(g).astype(dtype), jm,
                                       jv, lr=jnp.float32(lr), wd=wd)
        jw = jw.astype(dtype)
        tops.adam_update(tw, to(g), tm, tv, lr=torch.tensor(lr), wd=wd)
    for name, got, ref in (("weight", tw, jw), ("mean", tm, jm),
                           ("var", tv, jv)):
        assert got.dtype == getattr(torch, dtype)
        _adam_close(got, np.asarray(ref.astype(jnp.float32)), dtype, name)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_optimizer_matches_jax(dtype, wd):
    """Three updates through ``Optimizer.update``, bias correction from
    each index's update count; mean and variance in the weight's dtype."""
    w, grads, to = _adam_arrays(4, dtype)
    kw = dict(learning_rate=1e-3, wd=wd)
    jo, to_opt = jopt.create("adam", **kw), topt.create("adam", **kw)
    jw = nd.array(w).astype(dtype)
    tw = to(w)
    jst, tst = jo.create_state(0, jw), to_opt.create_state(0, tw)
    assert all(s.dtype == tw.dtype for s in tst)
    for g in grads:
        jo.update(0, jw, nd.array(g).astype(dtype), jst)
        to_opt.update(0, tw, to(g), tst)
    assert to_opt.num_update == jo.num_update == 3
    for name, got, ref in (("weight", tw, jw), ("mean", tst[0], jst[0]),
                           ("var", tst[1], jst[1])):
        _adam_close(got, ref.asnumpy().astype(np.float32) if dtype ==
                    "float32" else ref.astype("float32").asnumpy(), dtype,
                    name)


def test_convert_block_keeps_norm_tensors_fp32():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Conv2D(4, 3, in_channels=3), jnn.BatchNorm(in_channels=4),
             jnn.Dense(2, in_units=4))
    jnet.collect_params().initialize()
    jamp.convert_block(jnet, "bfloat16")
    tnet = HybridSequential()
    tnet.add(Conv2D(4, 3, in_channels=3, device="cpu"),
             BatchNorm(in_channels=4, device="cpu"),
             Dense(2, in_units=4, device="cpu"))
    convert_block(tnet, "bfloat16")
    ref = [str(p.data().dtype) for p in jnet.collect_params().values()]
    got = [str(t.dtype).split(".")[-1] for t in tnet.state_dict().values()]
    assert got == ref
    assert got.count("float32") == 4


def test_train_step_forces_rescale_grad_and_restores_it():
    """The step's gradients are those of the mean loss, so the optimizer's
    rescale_grad is 1.0 inside the step and back to its value after; the
    net returns to its mode."""
    torch.manual_seed(0)
    net = Dense(3, in_units=4, device="cpu")
    with torch.no_grad():
        net.weight.copy_(torch.randn(3, 4))
    w0 = net.weight.detach().clone()
    opt = topt.create("sgd", learning_rate=0.5, rescale_grad=123.0)
    seen = []
    update = opt.update

    def spy(index, weight, grad, state):
        seen.append(opt.rescale_grad)
        update(index, weight, grad, state)

    opt.update = spy
    x = torch.randn(5, 4)
    step = CompiledTrainStep(net.eval(), lambda out, y: (out - y) ** 2, opt)
    step(x, torch.zeros(5, 3))
    assert seen == [1.0, 1.0] and opt.rescale_grad == 123.0
    assert not net.training
    out = x @ w0.t()  # the bias starts at zero
    grad = 2 * out.t() @ x / out.numel()
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               (w0 - 0.5 * grad).numpy(), rtol=1e-5,
                               atol=1e-6)
