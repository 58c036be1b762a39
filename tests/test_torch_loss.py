"""Port parity: the Gluon losses (``HuberLoss``,
``SigmoidBinaryCrossEntropyLoss`` with ``pos_weight``, ``LogisticLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``KLDivLoss``, ``CTCLoss`` over the
``CTCLoss`` op, ``TripletLoss``, ``PoissonNLLLoss``,
``CosineEmbeddingLoss``, ``SDMLLoss``) against the JAX package, on the
CPU.

Each case feeds the same seeded numpy inputs to both packages' loss,
compares the per-sample losses and the gradients of a seeded random
weighting of them with respect to every float input, with
``sample_weight`` where the loss takes one.  The symbolic form is the
loss called on ``mx.sym`` variables, for the losses that have one in the
JAX package: its JSON must equal the JAX package's, and the port's graph,
evaluated on the same inputs, must give the NDArray loss.

Tolerances: fp32 losses within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs (each plus 1e-7 for references at 0).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

OUT_REL, GRAD_REL, ABS = 1e-4, 1e-3, 1e-7


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, rel, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + ABS
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


R = np.random.RandomState(0)
B = 4


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, shape).astype(np.float32)
    return R.randn(*shape).astype(np.float32)


def _signs(*shape):
    return np.where(R.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _bits(*shape):
    return (R.rand(*shape) > 0.5).astype(np.float32)


def _ctc_inputs(layout):
    t, n, c = 10, 3, 5
    data = _f(n, t, c) if layout == "NTC" else _f(t, n, c)
    label = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 4, 1, 2]], np.float32)
    return data, label


W = None  # an input left out (the losses take their inputs positionally)


def _sw(*shape):
    """A sample weight in [0, 1)."""
    return _f(*shape, lo=0, hi=1)


# name: (make(loss module), positional inputs (None: left out), indices of
#        the differentiated inputs)
CASES = {
    "huber": (lambda L: L.HuberLoss(rho=0.5), [_f(B, 3), _f(B, 3),
                                               _sw(B, 1)], [0]),
    "huber_weight": (lambda L: L.HuberLoss(weight=2.0),
                     [_f(B, 5), _f(B, 5)], [0]),
    "sigmoid_bce": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                    [_f(B, 3) * 3, _bits(B, 3), _sw(B, 1)], [0]),
    "sigmoid_bce_pos_weight": (
        lambda L: L.SigmoidBinaryCrossEntropyLoss(weight=0.5),
        [_f(B, 3) * 3, _bits(B, 3), W, _f(3, lo=0.5, hi=3)], [0]),
    "sigmoid_bce_from_sigmoid": (
        lambda L: L.SigmoidBCELoss(from_sigmoid=True),
        [_f(B, 3, lo=0.05, hi=0.95), _bits(B, 3), _sw(B, 1),
         _f(3, lo=0.5, hi=3)], [0]),
    "logistic_signed": (lambda L: L.LogisticLoss(),
                        [_f(B, 2), _signs(B, 2), _sw(B, 1)], [0]),
    "logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                        [_f(B, 2), _bits(B, 2)], [0]),
    "hinge": (lambda L: L.HingeLoss(margin=1.5),
              [_f(B, 3), _signs(B, 3), _sw(B, 1)], [0]),
    "squared_hinge": (lambda L: L.SquaredHingeLoss(),
                      [_f(B, 3), _signs(B, 3), _sw(B, 1)], [0]),
    "kl_div_log_space": (lambda L: L.KLDivLoss(),
                         [np.log(_f(B, 4, lo=0.05, hi=1)),
                          _f(B, 4, lo=0.01, hi=1), _sw(B, 1)], [0, 1]),
    "kl_div_logits": (lambda L: L.KLDivLoss(from_logits=False, axis=1),
                      [_f(B, 4), _f(B, 4, lo=0.01, hi=1)], [0]),
    "ctc_ntc": (lambda L: L.CTCLoss(),
                list(_ctc_inputs("NTC")) + [W, W, _f(3, lo=0.5, hi=1)], [0]),
    "ctc_tnc_lengths": (lambda L: L.CTCLoss(layout="TNC", weight=0.5),
                        list(_ctc_inputs("TNC"))
                        + [np.array([10, 7, 9], np.float32),
                           np.array([3, 2, 4], np.float32)], [0]),
    "triplet": (lambda L: L.TripletLoss(margin=0.5),
                [_f(B, 6), _f(B, 6), _f(B, 6), _sw(B)], [0, 1, 2]),
    "poisson_logits": (lambda L: L.PoissonNLLLoss(),
                       [_f(B, 3), _f(B, 3, lo=0, hi=4).round(), _sw(B, 1)],
                       [0]),
    "poisson_full": (lambda L: L.PoissonNLLLoss(from_logits=False,
                                                compute_full=True),
                     [_f(B, 3, lo=0.1, hi=3), _f(B, 3, lo=0, hi=5).round()],
                     [0]),
    "cosine_embedding": (lambda L: L.CosineEmbeddingLoss(margin=0.2),
                         [_f(B, 5), _f(B, 5), _signs(B), _sw(B)], [0, 1]),
    "sdml": (lambda L: L.SDMLLoss(smoothing_parameter=0.2),
             [_f(B, 6), _f(B, 6)], [0, 1]),
}


def _arrays(pkg, inputs):
    return [None if x is None else pkg.nd.array(x) for x in inputs]


def _run(pkg, L, case):
    make, inputs, diff = CASES[case]
    loss = make(L)
    arrays = _arrays(pkg, inputs)
    for i in diff:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = loss(*arrays)
    head = np.asarray(np.random.RandomState(9).rand(*out.shape),
                      np.float32)
    out.backward(pkg.nd.array(head))
    return out.asnumpy(), [arrays[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    jout, jgrads = _run(jmx, jloss, case)
    tout, tgrads = _run(tmx, tloss, case)
    _close(tout, jout, OUT_REL, "loss")
    assert np.all(np.isfinite(tout))
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        _close(a, b, GRAD_REL, f"gradient {i}")


def _symbolic(pkg, L, names, case):
    make, inputs, _ = CASES[case]
    names.reset()
    return make(L)(*[None if x is None else pkg.sym.var(f"in{i}")
                     for i, x in enumerate(inputs)])


# the JAX package's losses with a symbolic form (HuberLoss,
# PoissonNLLLoss's Stirling term and CosineEmbeddingLoss compare Symbols,
# which neither package's Symbol does; SDMLLoss needs the batch size)
SYMBOLIC = ["ctc_ntc", "ctc_tnc_lengths", "hinge", "kl_div_log_space",
            "kl_div_logits", "logistic_binary", "logistic_signed",
            "poisson_logits", "sigmoid_bce", "sigmoid_bce_from_sigmoid",
            "sigmoid_bce_pos_weight", "squared_hinge", "triplet"]


@pytest.mark.parametrize("case", SYMBOLIC)
def test_loss_symbolic_form_matches_jax(case):
    """The loss on ``mx.sym`` variables: the same graph JSON as the JAX
    package's, and the port's graph evaluated on the inputs equal to its
    NDArray loss."""
    tsym = _symbolic(tmx, tloss, TNames, case)
    jsym = _symbolic(jmx, jloss, JNames, case)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    make, inputs, _ = CASES[case]
    got = tsym.eval_with({f"in{i}": tmx.nd.array(x)
                          for i, x in enumerate(inputs) if x is not None})
    got = got[0] if isinstance(got, (list, tuple)) else got
    _close(got, make(tloss)(*_arrays(tmx, inputs)), OUT_REL, "symbolic")


def test_losses_train_through_compiled_train_step():
    """A loss with a symbolic body runs on tensors too: a HuberLoss step
    through ``CompiledTrainStep`` on the CPU moves the weights as a
    record/backward/step loop of the JAX package does."""
    import torch
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.convert import params_from_mxnet
    from mxnet_tpu_torch.executor import CompiledTrainStep
    x, y = _f(8, 5), _f(8, 3)
    jnet = jmx.gluon.nn.Dense(3, in_units=5, prefix="d_")
    jnet.initialize(jmx.init.Xavier())
    tnet = tmx.gluon.nn.Dense(3, in_units=5, prefix="d_", device="cpu")
    params_from_mxnet({k: p.data().asnumpy() for k, p in
                       jnet.collect_params().items()}, tnet)
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    with jmx.autograd.record():
        out = jloss.HuberLoss(rho=0.5)(jnet(jmx.nd.array(x)),
                                       jmx.nd.array(y))
    out.backward()
    trainer.step(8)
    step = CompiledTrainStep(tnet, tloss.HuberLoss(rho=0.5),
                             optimizer.create("sgd", learning_rate=0.5))
    step(torch.from_numpy(x), torch.from_numpy(y))
    _close(tnet.weight.detach().numpy(), jnet.weight.data().asnumpy(),
           GRAD_REL, "weight after a step")
