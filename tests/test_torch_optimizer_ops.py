"""Port parity: every optimizer update op of the registry (the 36 of
``mxnet_tpu/ops/optimizer_ops.py`` and ``multi_sgd_update`` /
``multi_sgd_mom_update``), through ``mx.nd`` in both packages on the same
seeded numpy inputs.

Each op runs with a weight decay, a gradient rescale and clip and, where
the op has them, its other options set.  Tolerance, as in
``tests/test_torch_optimizer.py``: an fp32 output within 1e-6 of its
largest |value|; a bf16 or fp16 output within one ulp of its dtype of
each reference element (both packages take the Python scalars in the
array's dtype and round each op to it, but XLA may keep excess precision
inside the op's fusion).  The fp16/bf16 weights of the ``mp_*`` ops keep
fp32 master copies and states.  ``out=`` writes the outputs back into the
given arrays in both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

SHAPES = ((6, 5), (4,))
LRS, WDS = (0.1, 0.05), (0.01, 0.0)
PREP = dict(rescale_grad=0.5, clip_gradient=0.7)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _draw(rng, kind, shape):
    if kind == "n":          # weights, gradients, signed states
        return rng.randn(*shape)
    if kind == "s":          # small signed states
        return 0.1 * rng.randn(*shape)
    if kind == "p":          # positive states (under a square root)
        return rng.uniform(0.5, 1.5, shape)
    if kind == "P":          # positive and above "s"² by a margin
        return rng.uniform(1.0, 2.0, shape)
    raise ValueError(kind)


def _spec(groups, extra=()):
    """Inputs: each group's ``(kind, dtype role)`` over SHAPES[i], then
    ``extra`` as ``(kind, shape, role)``; role "w" is the case's dtype,
    "f" float32."""
    out = []
    for i, group in enumerate(groups):
        out += [(k, SHAPES[i], r) for k, r in group]
    return out + list(extra)


W, G = ("n", "w"), ("n", "w")
ONE = [[W, G]]
TWO = ONE * 2

# name -> (inputs, params); the single-dtype ops run in fp32 and bf16
SINGLE = {
    "sgd_update": (_spec(ONE), dict(lr=0.1, wd=0.01, **PREP)),
    "sgd_mom_update": (_spec([[W, G, ("s", "w")]]),
                       dict(lr=0.1, momentum=0.9, wd=0.01, **PREP)),
    "nag_mom_update": (_spec([[W, G, ("s", "w")]]),
                       dict(lr=0.1, momentum=0.9, wd=0.01, **PREP)),
    "signsgd_update": (_spec(ONE), dict(lr=0.1, wd=0.01, **PREP)),
    "signum_update": (_spec([[W, G, ("s", "w")]]),
                      dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.05,
                           **PREP)),
    "adam_update": (_spec([[W, G, ("s", "w"), ("p", "w")]]),
                    dict(lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8,
                         wd=0.01, **PREP)),
    "adamw_update": (_spec([[W, G, ("s", "w"), ("p", "w")]]),
                     dict(lr=0.01, wd=0.01, eta=0.9, **PREP)),
    "_contrib_adamw_update": (_spec([[W, G, ("s", "w"), ("p", "w")]]),
                              dict(lr=0.01, wd=0.01, **PREP)),
    "ftml_update": (_spec([[W, G, ("p", "w"), ("p", "w"), ("s", "w")]]),
                    dict(lr=0.05, wd=0.01, rescale_grad=0.5, clip_grad=0.7,
                         t=3)),
    "ftrl_update": (_spec([[W, G, ("n", "w"), ("p", "w")]]),
                    dict(lr=0.1, lamda1=0.3, beta=1.0, wd=0.01, **PREP)),
    "rmsprop_update": (_spec([[W, G, ("p", "w")]]),
                       dict(lr=0.01, gamma1=0.9, wd=0.01, clip_weights=1.5,
                            **PREP)),
    "rmspropalex_update": (
        _spec([[W, G, ("P", "w"), ("s", "w"), ("s", "w")]]),
        dict(lr=0.01, gamma1=0.95, gamma2=0.9, wd=0.01, clip_weights=1.5,
             **PREP)),
    "lamb_update_phase1": (_spec([[W, G, ("s", "w"), ("p", "w")]]),
                           dict(t=3, wd=0.01, **PREP)),
    "lamb_update_phase2": (_spec([[W, ("n", "w")]], [("p", (1,), "w"),
                                                     ("p", (1,), "w")]),
                           dict(lr=0.05, lower_bound=0.8, upper_bound=1.2)),
    "_contrib_group_adagrad_update": (
        _spec([[W, G]], [("p", (6,), "w")]),
        dict(lr=0.1, epsilon=1e-5, **PREP)),
    "_sparse_adagrad_update": (_spec([[W, G, ("p", "w")]]),
                               dict(lr=0.1, wd=0.01, **PREP)),
    "all_finite": (_spec([[W]]), {}),
    "multi_all_finite": (_spec([[W], [W]]), dict(num_arrays=2)),
    "multi_sum_sq": (_spec([[W], [W]]), dict(num_arrays=2, scale=0.5)),
    "reset_arrays": (_spec([[W], [W]]), dict(num_arrays=2)),
    "multi_sgd_update": (_spec(TWO), dict(lrs=LRS, wds=WDS, num_weights=2,
                                          **PREP)),
    "multi_sgd_mom_update": (_spec([[W, G, ("s", "w")]] * 2),
                             dict(lrs=LRS, wds=WDS, momentum=0.9,
                                  num_weights=2, **PREP)),
    "_multi_lamb_update": (_spec([[W, G, ("s", "w"), ("p", "w")]] * 2),
                           dict(learning_rates=LRS, wds=WDS,
                                step_count=(2, 3), lower_bound=0.1,
                                upper_bound=10.0, num_tensors=2, **PREP)),
    "_multi_adamw_update": (_spec([[W, G, ("s", "w"), ("p", "w")]] * 2,
                                  [("p", (1,), "f")]),
                            dict(lrs=LRS, wds=WDS, etas=(1.0, 0.9),
                                 clip_gradient=0.7, num_weights=2)),
    "preloaded_multi_sgd_update": (_spec(TWO, [("p", (2,), "f"),
                                               ("s", (2,), "f")]),
                                   dict(num_weights=2, **PREP)),
    "preloaded_multi_sgd_mom_update": (
        _spec([[W, G, ("s", "w")]] * 2, [("p", (2,), "f"),
                                         ("s", (2,), "f")]),
        dict(momentum=0.9, num_weights=2, **PREP)),
    "multi_lars": ([("p", (4,), "f"), ("p", (4,), "f"), ("p", (4,), "f"),
                    ("s", (4,), "f")],
                   dict(eta=0.01, eps=1e-8, rescale_grad=0.5)),
}

LP, F = ("n", "w"), ("n", "f")
# name -> (inputs, params); the weights (and gradients) in fp16 and bf16,
# their masters and states in fp32
MIXED = {
    "mp_sgd_update": (_spec([[LP, LP, F]]), dict(lr=0.1, wd=0.01, **PREP)),
    "mp_sgd_mom_update": (_spec([[LP, LP, ("s", "f"), F]]),
                          dict(lr=0.1, momentum=0.9, wd=0.01, **PREP)),
    "mp_nag_mom_update": (_spec([[LP, LP, ("s", "f"), F]]),
                          dict(lr=0.1, momentum=0.9, wd=0.01, **PREP)),
    "mp_lamb_update_phase1": (_spec([[LP, LP, ("s", "f"), ("p", "f"), F]]),
                              dict(t=3, wd=0.01, **PREP)),
    "mp_lamb_update_phase2": (_spec([[LP, F]], [("p", (1,), "f"),
                                                ("p", (1,), "f"),
                                                ("n", (6, 5), "f")]),
                              dict(lr=0.05, lower_bound=0.8,
                                   upper_bound=1.2)),
    "multi_mp_sgd_update": (_spec([[LP, LP, F]] * 2),
                            dict(lrs=LRS, wds=WDS, num_weights=2, **PREP)),
    "multi_mp_sgd_mom_update": (_spec([[LP, LP, ("s", "f"), F]] * 2),
                                dict(lrs=LRS, wds=WDS, momentum=0.9,
                                     num_weights=2, **PREP)),
    "preloaded_multi_mp_sgd_update": (
        _spec([[LP, LP, F]] * 2, [("p", (2,), "f"), ("s", (2,), "f")]),
        dict(num_weights=2, **PREP)),
    "preloaded_multi_mp_sgd_mom_update": (
        _spec([[LP, LP, ("s", "f"), F]] * 2, [("p", (2,), "f"),
                                               ("s", (2,), "f")]),
        dict(momentum=0.9, num_weights=2, **PREP)),
    "_multi_mp_lamb_update": (
        _spec([[LP, LP, ("s", "f"), ("p", "f"), F]] * 2),
        dict(learning_rates=LRS, wds=WDS, step_count=(2, 3),
             bias_correction=False, num_tensors=2, **PREP)),
    "_mp_adamw_update": (_spec([[LP, LP, ("s", "f"), ("p", "f"), F]],
                               [("p", (1,), "f")]),
                         dict(lr=0.01, wd=0.01, eta=0.9, clip_gradient=0.7)),
    "_multi_mp_adamw_update": (
        _spec([[LP, LP, ("s", "f"), ("p", "f"), F]] * 2, [("p", (1,), "f")]),
        dict(lrs=LRS, wds=WDS, etas=(1.0, 0.9), clip_gradient=0.7,
             num_weights=2)),
}


def _inputs(seed, spec, dtype):
    rng = np.random.RandomState(seed)
    arrays = [(_draw(rng, kind, shape).astype(np.float32),
               dtype if role == "w" else "float32")
              for kind, shape, role in spec]
    return ([jmx.nd.array(a, dtype=d) for a, d in arrays],
            [tmx.nd.array(a, dtype=d) for a, d in arrays])


def _ulp(ref, dtype):
    mant = {"bfloat16": 7, "float16": 10}[dtype]
    ref = np.abs(ref)
    with np.errstate(divide="ignore"):
        e = np.floor(np.log2(np.where(ref > 0, ref, 1.0)))
    return np.where(ref > 0, 2.0 ** (e - mant), 0.0)


def _close(got, ref, what):
    assert str(got.dtype) == str(ref.dtype), (what, got.dtype, ref.dtype)
    dtype = str(ref.dtype)
    g = got.astype("float32").asnumpy().astype(np.float64)
    r = ref.astype("float32").asnumpy().astype(np.float64)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    if dtype == "float32":
        bound = 1e-6 * float(np.abs(r).max()) if r.size else 0.0
        err = float(np.abs(g - r).max()) if r.size else 0.0
        assert err <= bound, f"{what}: max err {err} > {bound}"
        return
    over = np.abs(g - r) - _ulp(r, dtype)
    assert over.max() <= 0, f"{what}: {int((over > 0).sum())} of " \
                            f"{over.size} elements off by more than one ulp"


def _outputs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _run(name, spec, params, dtype, seed):
    jin, tin = _inputs(seed, spec, dtype)
    ref = _outputs(getattr(jmx.nd, name)(*jin, **params))
    got = _outputs(getattr(tmx.nd, name)(*tin, **params))
    assert len(got) == len(ref), (name, len(got), len(ref))
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"{name} output {i}")
    # the op returns new arrays: its inputs are as they were
    again, _ = _inputs(seed, spec, dtype)
    for a, b in zip(tin, again):
        assert np.array_equal(a.astype("float32").asnumpy(),
                              b.astype("float32").asnumpy())


# multi_lars takes float32 rates and sums only
@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in sorted(SINGLE) for d in ("float32", "bfloat16")
    if n != "multi_lars" or d == "float32"])
def test_op_matches_jax(name, dtype):
    spec, params = SINGLE[name]
    _run(name, spec, params, dtype, seed=len(name))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_precision_op_matches_jax(name, dtype):
    spec, params = MIXED[name]
    _run(name, spec, params, dtype, seed=len(name) + 1)


@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_phases_without_bounds(bias_correction):
    """Phase 1 with and without its bias correction, then phase 2 on the
    norms as the LAMB optimizer takes them, bounds off."""
    spec, params = SINGLE["lamb_update_phase1"]
    jin, tin = _inputs(7, spec, "float32")
    params = dict(params, bias_correction=bias_correction)
    ref = jmx.nd.lamb_update_phase1(*jin, **params)
    got = tmx.nd.lamb_update_phase1(*tin, **params)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"phase1 output {i}")
    jw, tw = jin[0], tin[0]
    j2 = jmx.nd.lamb_update_phase2(jw, ref[0], jmx.nd.norm(jw),
                                   jmx.nd.norm(ref[0]), lr=0.05)
    t2 = tmx.nd.lamb_update_phase2(tw, got[0], tmx.nd.norm(tw),
                                   tmx.nd.norm(got[0]), lr=0.05)
    _close(t2, j2, "phase2")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_finite_checks_see_a_nan(pkg):
    mx = jmx if pkg == "jax" else tmx
    a = np.ones((3, 4), np.float32)
    b = a.copy()
    b[1, 2] = np.nan
    assert mx.nd.all_finite(mx.nd.array(a)).asnumpy().tolist() == [1.0]
    assert mx.nd.all_finite(mx.nd.array(b)).asnumpy().tolist() == [0.0]
    assert mx.nd.multi_all_finite(mx.nd.array(a), mx.nd.array(b),
                                  num_arrays=2).asnumpy().tolist() == [0.0]


def test_out_writes_back_in_place():
    """``out=`` rebinds the given arrays to the op's outputs, as in the
    JAX package; the arrays' values then match its."""
    spec, params = SINGLE["sgd_mom_update"]
    jin, tin = _inputs(3, spec, "float32")
    jmx.nd.sgd_mom_update(*jin, out=(jin[0], jin[2]), **params)
    tmx.nd.sgd_mom_update(*tin, out=(tin[0], tin[2]), **params)
    _close(tin[0], jin[0], "weight")
    _close(tin[2], jin[2], "momentum")
    spec, params = SINGLE["lamb_update_phase2"]
    jin, tin = _inputs(4, spec, "float32")
    jmx.nd.lamb_update_phase2(*jin, out=jin[0], **params)
    tmx.nd.lamb_update_phase2(*tin, out=tin[0], **params)
    _close(tin[0], jin[0], "lamb weight")


def test_every_update_op_and_alias_is_registered():
    """Each JAX update op name, and each alias, reaches the port's
    registry and ``mx.nd``."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    names = set(SINGLE) | set(MIXED)
    assert len(names) == 39     # 38 ops and the adamw alias
    for name in names:
        op = jreg.get(name)
        assert hasattr(tmx.nd, name)
        for alias in op.aliases:
            assert treg.get(alias) is treg.get(name), alias
