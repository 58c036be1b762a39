"""Port parity: ``mx.sym`` (Symbol, inference, JSON, the Executor) and the
nn registry ops of ``mx.nd`` against mxnet_tpu's, on the CPU.

Mirrors the non-Module tests of ``tests/test_symbol.py``: each graph is
built in both packages, fed the same seeded numpy arrays, and its
outputs, gradients and BatchNorm moving statistics compared.  Node
counters are per process, so tests name the nodes they compare.

Tolerance: fp32 values within 1e-5 of each tensor's largest |value| plus
1e-6 (XLA and PyTorch sum products and statistics in other orders);
structural results (names, shapes, dtypes) are compared exactly.
"""
import copy
import json

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError

REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, rel=REL, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got,
                     np.float64)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref,
                     np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max(initial=0.0)) + 1e-6
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _mlp(mx):
    data = mx.sym.var("data")
    fc1 = mx.sym.FullyConnected(data, mx.sym.var("fc1_weight"),
                                mx.sym.var("fc1_bias"), num_hidden=8,
                                name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    return mx.sym.FullyConnected(act, mx.sym.var("fc2_weight"),
                                 mx.sym.var("fc2_bias"), num_hidden=3,
                                 name="fc2")


def _bindings(mx, sym, seed=0, **shapes):
    rng = np.random.RandomState(seed)
    arg_shapes = sym.infer_shape(**shapes)[0]
    return {n: mx.nd.array(rng.uniform(-1, 1, s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)}


# ---------------------------------------------------------------- compose
def test_compose_and_list_arguments():
    for mx in (jmx, tmx):
        sym = _mlp(mx)
        assert sym.list_arguments() == ["data", "fc1_weight", "fc1_bias",
                                        "fc2_weight", "fc2_bias"]
        assert sym.list_outputs() == ["fc2_output"]


def test_infer_shape_fills_params_from_data():
    res = [_mlp(mx).infer_shape(data=(4, 10)) for mx in (jmx, tmx)]
    assert res[0] == res[1] == (
        [(4, 10), (8, 10), (8,), (3, 8), (3,)], [(4, 3)], [])


def test_infer_shape_underdetermined_returns_none():
    assert _mlp(tmx).infer_shape() == (None, None, None)


def test_infer_type():
    """Dtypes ride the shape pass (declared shapes): the same dtypes as
    the JAX package's, where an undeclared weight takes its data input's
    dtype."""
    res = []
    for mx in (jmx, tmx):
        tok = mx.sym.var("tok", shape=(2, 5), dtype="int32")
        emb = mx.sym.Embedding(tok, input_dim=7, output_dim=4, name="e")
        out = mx.sym.FullyConnected(emb, num_hidden=3, flatten=True,
                                    name="f")
        res.append(out.infer_type())
        assert out.infer_shape()[1] == [(2, 3)]
    assert res[0] == res[1]
    assert str(res[1][0][0]) == "int32"


def test_arith_operators_and_eval():
    for mx in (jmx, tmx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        c = 2.0 * a + b / 2.0 - 1.0
        out = c.eval_with({"a": mx.nd.ones((2, 2)),
                           "b": mx.nd.ones((2, 2)) * 4})
        np.testing.assert_allclose(out.asnumpy(), 3.0)


def test_json_crosses_between_packages():
    """Each package's JSON loads in the other and evaluates to the same
    outputs; the node lists are equal."""
    jsym, tsym = _mlp(jmx), _mlp(tmx)
    assert json.loads(jsym.tojson()) == json.loads(tsym.tojson())
    jb = _bindings(jmx, jsym, data=(2, 10))
    tb = {k: tmx.nd.array(v.asnumpy()) for k, v in jb.items()}
    ref = jsym.eval_with(jb)
    _close(tmx.sym.load_json(jsym.tojson()).eval_with(tb), ref)
    _close(jmx.sym.load_json(tsym.tojson()).eval_with(jb),
           tsym.eval_with(tb))
    _close(tsym.eval_with(tb), ref)


def test_group_and_getitem():
    a = tmx.sym.var("a")
    g = tmx.sym.Group([a * 2, a + 1])
    assert len(g) == 2
    outs = g.eval_with({"a": tmx.nd.ones((2,))})
    np.testing.assert_allclose(outs[0].asnumpy(), 2.0)
    np.testing.assert_allclose(outs[1].asnumpy(), 2.0)
    np.testing.assert_allclose(
        g[0].eval_with({"a": tmx.nd.ones((2,))}).asnumpy(), 2.0)
    second = g.list_outputs()[1]
    assert g[second].list_outputs() == [second]


def test_get_internals():
    outs = [_mlp(mx).get_internals().list_outputs() for mx in (jmx, tmx)]
    assert outs[0] == outs[1]
    assert "fc1_output" in outs[1] and "relu1_output" in outs[1]


# --------------------------------------------------------------- executor
def test_executor_forward_backward():
    """simple_bind, forward(is_train) and backward with a head gradient:
    outputs and every argument's gradient as the JAX Executor's."""
    exes = []
    rng = np.random.RandomState(0)
    values = None
    for mx in (jmx, tmx):
        ex = _mlp(mx).simple_bind(grad_req="write", data=(4, 10))
        if values is None:
            values = {k: rng.uniform(-1, 1, a.shape).astype(np.float32)
                      for k, a in ex.arg_dict.items()}
        ex.copy_params_from({k: mx.nd.array(v) for k, v in values.items()})
        outs = ex.forward(is_train=True)
        assert outs[0].shape == (4, 3)
        ex.backward(mx.nd.array(np.linspace(-1, 1, 12, dtype=np.float32)
                                .reshape(4, 3)))
        exes.append(ex)
    jex, tex = exes
    _close(tex.outputs[0], jex.outputs[0], what="output")
    assert list(tex.output_dict) == list(jex.output_dict) == ["fc2_output"]
    for name in values:
        _close(tex.grad_dict[name], jex.grad_dict[name], what=name)
    assert np.abs(tex.grad_dict["fc1_weight"].asnumpy()).sum() > 0


def test_executor_grad_req_add_and_null():
    for mx in (jmx, tmx):
        a = mx.sym.var("a")
        b = mx.sym.var("b")
        ex = (a * a * b).bind(
            args={"a": mx.nd.ones((2,)), "b": mx.nd.ones((2,)) * 3},
            args_grad={"a": mx.nd.zeros((2,)), "b": mx.nd.zeros((2,))},
            grad_req={"a": "add", "b": "null"})
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward(mx.nd.ones((2,)))
        np.testing.assert_allclose(ex.grad_dict["a"].asnumpy(), 12.0)
        np.testing.assert_allclose(ex.grad_dict["b"].asnumpy(), 0.0)


def test_executor_backward_needs_a_training_forward():
    ex = _mlp(tmx).simple_bind(data=(2, 10))
    ex.forward(is_train=False)
    with pytest.raises(MXNetError, match="forward"):
        ex.backward()


def test_executor_graph_serves_one_backward():
    """``forward(is_train=True)`` then ``backward`` works step after step
    with the same gradients; the graph is freed by its backward (a second
    backward raises, as one without a training forward does) and dropped
    by the next forward."""
    ex = _mlp(tmx).simple_bind(data=(4, 10))
    ex.copy_params_from(_bindings(tmx, _mlp(tmx), data=(4, 10)))
    head = tmx.nd.array(np.linspace(-1, 1, 12, dtype=np.float32)
                        .reshape(4, 3))
    grads = []
    for _ in range(2):
        ex.forward(is_train=True)
        ex.backward(head)
        grads.append(ex.grad_dict["fc1_weight"].asnumpy())
        assert ex._graph is None
        with pytest.raises(MXNetError, match="forward"):
            ex.backward(head)
    np.testing.assert_array_equal(grads[0], grads[1])
    assert np.abs(grads[0]).sum() > 0
    ex.forward(is_train=True)
    ex.forward(is_train=False)
    with pytest.raises(MXNetError, match="forward"):
        ex.backward(head)


def test_executor_reshape_keeps_weights():
    ex = _mlp(tmx).simple_bind(data=(4, 10))
    ex.arg_dict["fc1_weight"][:] = 0.5
    ex2 = ex.reshape(data=(6, 10))
    assert ex2.arg_dict["data"].shape == (6, 10)
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert ex2.forward()[0].shape == (6, 3)
    with pytest.raises(MXNetError, match="unknown argument"):
        ex.copy_params_from({"nope": tmx.nd.ones((1,))})


def _bn_net(mx):
    data = mx.sym.var("data")
    net = mx.sym.BatchNorm(mx.sym.FullyConnected(data, num_hidden=4,
                                                 name="f0"),
                           name="bn0", fix_gamma=False)
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(net, num_hidden=2, name="f1"),
        mx.sym.var("softmax_label"), name="sm")


def test_symbolic_batchnorm_moving_stats_update():
    """A training forward EMA-updates the BatchNorm moving statistics
    (the reference kernel mutates them); they, the SoftmaxOutput
    gradients (its own loss gradient, whatever the head gradient) and the
    outputs equal the JAX Executor's over two steps."""
    rng = np.random.RandomState(0)
    x = (rng.randn(16, 4) * 5 + 10).astype(np.float32)
    y = rng.randint(0, 2, 16).astype(np.float32)
    exes, values = [], None
    for mx in (jmx, tmx):
        ex = _bn_net(mx).simple_bind(data=(16, 4), softmax_label=(16,))
        assert list(ex.aux_dict) == ["bn0_moving_mean", "bn0_moving_var"]
        if values is None:
            values = {k: rng.uniform(-1, 1, a.shape).astype(np.float32)
                      for k, a in ex.arg_dict.items()}
            values["data"], values["softmax_label"] = x, y
        ex.copy_params_from({k: mx.nd.array(v) for k, v in values.items()},
                            {"bn0_moving_var": mx.nd.ones((4,))})
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        exes.append(ex)
    jex, tex = exes
    mm = tex.aux_dict["bn0_moving_mean"].asnumpy()
    assert not np.allclose(mm, 0.0)
    for name in jex.aux_dict:
        _close(tex.aux_dict[name], jex.aux_dict[name], what=name)
    for name in ("f0_weight", "f1_weight", "bn0_gamma", "bn0_beta"):
        _close(tex.grad_dict[name], jex.grad_dict[name], what=name)
    _close(tex.outputs[0], jex.outputs[0])
    # predict mode reads the moving statistics and leaves them alone
    tex.forward(is_train=False)
    np.testing.assert_array_equal(tex.aux_dict["bn0_moving_mean"].asnumpy(),
                                  mm)


def test_symbol_hash_eq_contract():
    a = tmx.sym.var("a")
    b = copy.copy(a)
    assert a == b and hash(a) == hash(b)
    assert len({a, b}) == 1


def test_deep_graph_no_recursion_error():
    x = tmx.sym.var("x")
    for _ in range(3000):
        x = x + 1.0
    assert x.list_arguments() == ["x"]
    assert x.infer_shape(x=(2, 2))[1] == [(2, 2)]


def test_symbol_auto_created_param_variables():
    """Omitted learnable inputs become ``{node}_{suffix}`` variables, as
    in the JAX package, a name scope's prefix applied once."""
    lists = []
    for mx in (jmx, tmx):
        data = mx.sym.Variable("data")
        w = mx.sym.var("myw")
        with mx.name.Prefix("p_"):
            fcp = mx.sym.FullyConnected(data, num_hidden=2, name="fcp")
        lists.append([
            mx.sym.FullyConnected(data, num_hidden=3,
                                  name="fc1").list_arguments(),
            mx.sym.FullyConnected(data, num_hidden=3, no_bias=True,
                                  name="fcnb").list_arguments(),
            mx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                               name="c0").list_arguments(),
            mx.sym.Embedding(data, input_dim=10, output_dim=4,
                             name="e0").list_arguments(),
            mx.sym.FullyConnected(data, w, num_hidden=3,
                                  name="fc2").list_arguments(),
            mx.sym.LayerNorm(data, name="ln").list_arguments(),
            fcp.list_arguments()])
    assert lists[0] == lists[1]
    assert lists[1][1] == ["data", "fcnb_weight"]
    assert "p_fcp_weight" in lists[1][-1]


def test_symbol_batchnorm_visible_outputs_and_aux():
    for mx in (jmx, tmx):
        data = mx.sym.Variable("data")
        bn = mx.sym.BatchNorm(data, name="bn0")
        assert len(bn._outputs) == 1
        assert bn.list_arguments() == ["data", "bn0_gamma", "bn0_beta"]
        assert bn.list_auxiliary_states() == ["bn0_moving_mean",
                                              "bn0_moving_var"]
        assert len(mx.sym.Activation(bn, act_type="relu")._outputs) == 1
        assert len(mx.sym.BatchNorm(data, name="bn3",
                                    output_mean_var=True)._outputs) == 3


def test_symbol_alias_composers_get_auto_vars():
    data = tmx.sym.Variable("data")
    bn = tmx.sym.batch_norm(data, name="ba")
    assert bn.list_arguments() == ["data", "ba_gamma", "ba_beta"]
    assert bn.list_auxiliary_states() == ["ba_moving_mean", "ba_moving_var"]
    fc = tmx.sym.fully_connected(data, num_hidden=2, name="fa")
    assert fc.list_arguments() == ["data", "fa_weight", "fa_bias"]


def test_symbol_explicit_stat_vars_are_aux():
    data = tmx.sym.Variable("data")
    bn = tmx.sym.BatchNorm(data, tmx.sym.var("g"), tmx.sym.var("b"),
                           tmx.sym.var("mm"), tmx.sym.var("mv"), name="be")
    assert bn.list_arguments() == ["data", "g", "b"]
    assert bn.list_auxiliary_states() == ["mm", "mv"]


def test_load_json_coerces_repr_attrs():
    """Reference-era JSON stores attrs as Python reprs ('False', '(1, 1)');
    they load as values, and the graph evaluates as the JAX package's."""
    graph = {
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "g", "inputs": []},
            {"op": "null", "name": "b", "inputs": []},
            {"op": "null", "name": "mm", "inputs": []},
            {"op": "null", "name": "mv", "inputs": []},
            {"op": "BatchNorm", "name": "bn",
             "attrs": {"use_global_stats": "False", "fix_gamma": "True",
                       "eps": "0.001", "axis": "1", "momentum": "0.9"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0],
                        [4, 0, 0]]},
            {"op": "Pooling", "name": "pool",
             "attrs": {"kernel": "(2, 2)", "stride": "(2, 2)",
                       "pool_type": "avg", "global_pool": "False"},
             "inputs": [[5, 0, 0]]},
        ],
        "heads": [[6, 0, 0]],
    }
    sym = tmx.sym.load_json(json.dumps(graph))
    node = sym._outputs[0][0].inputs[0][0]
    assert node.attrs["use_global_stats"] is False
    assert node.attrs["fix_gamma"] is True
    assert node.attrs["eps"] == 0.001 and node.attrs["axis"] == 1
    assert sym._outputs[0][0].attrs["pool_type"] == "avg"
    rng = np.random.RandomState(1)
    vals = {"data": rng.randn(2, 3, 4, 4), "g": rng.rand(3) + 0.5,
            "b": rng.randn(3), "mm": rng.randn(3), "mv": rng.rand(3) + 0.5}
    outs = []
    for mx in (jmx, tmx):
        s = mx.sym.load_json(json.dumps(graph))
        outs.append(s.eval_with({k: mx.nd.array(v.astype(np.float32))
                                 for k, v in vals.items()}))
    _close(outs[1], outs[0])


def test_batchnorm_fast_variance_knob(monkeypatch):
    """MXNET_TPU_FAST_VARIANCE=0 selects the centred variance in the
    registry op; both forms agree on well-scaled data, and the centred one
    still normalises |mean| >> std."""
    rng = np.random.RandomState(3)
    x = tmx.nd.array(rng.randn(8, 4, 5, 5).astype(np.float32))
    g, b = tmx.nd.ones((4,)), tmx.nd.zeros((4,))
    mm, mv = tmx.nd.zeros((4,)), tmx.nd.ones((4,))
    outs = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_FAST_VARIANCE", knob)
        with tmx.autograd.record():
            outs[knob] = tmx.nd.BatchNorm(x, g, b, mm, mv,
                                          fix_gamma=False)[0].asnumpy()
    np.testing.assert_allclose(outs["0"], outs["1"], atol=1e-5)
    xx = tmx.nd.array(rng.randn(256, 2).astype(np.float32) + 3e4)
    with tmx.autograd.record():
        o = tmx.nd.BatchNorm(xx, tmx.nd.ones((2,)), tmx.nd.zeros((2,)),
                             tmx.nd.zeros((2,)), tmx.nd.ones((2,)),
                             fix_gamma=False)[0]
    assert float(np.abs(o.asnumpy()).max()) < 10.0


# ------------------------------------------------- the nn ops of mx.nd
def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cases(rng):
    """case -> (op, numpy inputs, params, training)."""
    x4 = _rand(rng, 2, 3, 6, 6)

    def bn_inputs():
        return [x4, _rand(rng, 3), _rand(rng, 3), _rand(rng, 3),
                np.abs(_rand(rng, 3)) + 0.5]
    qkv = [_rand(rng, 2, 5, 8) for _ in range(3)]
    return {
        "FullyConnected": ("FullyConnected", [_rand(rng, 4, 2, 3),
                                              _rand(rng, 5, 6),
                                              _rand(rng, 5)],
                           {"num_hidden": 5}, False),
        "FullyConnected_nobias_noflat": (
            "FullyConnected", [_rand(rng, 4, 2, 3), _rand(rng, 5, 3)],
            {"num_hidden": 5, "no_bias": True, "flatten": False}, False),
        "Convolution": ("Convolution", [x4, _rand(rng, 4, 3, 3, 3),
                                        _rand(rng, 4)],
                        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                         "num_filter": 4}, False),
        "Convolution_group": ("Convolution", [_rand(rng, 2, 4, 5, 5),
                                              _rand(rng, 4, 2, 3, 3)],
                              {"kernel": (3, 3), "num_filter": 4,
                               "num_group": 2, "no_bias": True}, False),
        "Pooling_max": ("Pooling", [x4], {"kernel": (3, 3),
                                          "stride": (2, 2), "pad": (1, 1),
                                          "pool_type": "max"}, False),
        "Pooling_avg_full": ("Pooling", [x4],
                             {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "avg",
                              "pooling_convention": "full",
                              "count_include_pad": False}, False),
        "Pooling_global": ("Pooling", [x4], {"kernel": (1, 1),
                                             "global_pool": True,
                                             "pool_type": "avg"}, False),
        **{f"Activation_{a}": ("Activation", [x4], {"act_type": a}, False)
           for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign",
                     "gelu")},
        "BatchNorm_train": ("BatchNorm", bn_inputs(),
                            {"fix_gamma": False, "eps": 1e-5}, True),
        "BatchNorm_infer": ("BatchNorm", bn_inputs(),
                            {"fix_gamma": False, "eps": 1e-5}, False),
        "LayerNorm": ("LayerNorm", [_rand(rng, 2, 5, 8), _rand(rng, 8),
                                    _rand(rng, 8)], {"eps": 1e-5}, False),
        "Embedding": ("Embedding", [rng.randint(0, 7, (3, 4)).astype(
            np.int32), _rand(rng, 7, 5)],
            {"input_dim": 7, "output_dim": 5}, False),
        "Dropout": ("Dropout", [x4], {"p": 0.5}, False),
        "softmax": ("softmax", [_rand(rng, 3, 6)],
                    {"axis": -1, "temperature": 2.0}, False),
        "softmax_length": ("softmax", [_rand(rng, 3, 6),
                                       np.array([2, 6, 1], np.float32)],
                           {"axis": -1, "use_length": True}, False),
        "log_softmax": ("log_softmax", [_rand(rng, 3, 6)], {"axis": 1},
                        False),
        "SoftmaxOutput": ("SoftmaxOutput", [_rand(rng, 4, 5),
                                            rng.randint(0, 5, 4).astype(
                                                np.float32)], {}, False),
        "flash_attention": ("flash_attention", qkv,
                            {"num_heads": 2, "causal": True}, False),
        "flash_attention_valid": ("flash_attention",
                                  qkv + [np.array([3, 5], np.int32)],
                                  {"num_heads": 2}, False),
        "conv1x1_bn_stats": ("_contrib_conv1x1_bn_stats",
                             [_rand(rng, 2, 4, 4, 3),
                              _rand(rng, 5, 3, 1, 1)], {"stride": 2}, False),
        "conv1x1_bn_stats_folded": ("_contrib_conv1x1_bn_stats",
                                    [_rand(rng, 2, 4, 4, 3),
                                     _rand(rng, 5, 3, 1, 1)],
                                    {"with_stats": False, "relu_in": True},
                                    False),
        # ignored rows: the default ignore_label -1, another label, and the
        # 'valid' normalisation over the rows kept
        "SoftmaxOutput_ignore_neg1": (
            "SoftmaxOutput", [_rand(rng, 5, 4),
                              np.array([1, -1, 3, -1, 0], np.float32)],
            {"use_ignore": True}, False),
        "SoftmaxOutput_ignore_3": (
            "SoftmaxOutput", [_rand(rng, 5, 4),
                              np.array([3, 1, 3, 2, 0], np.float32)],
            {"use_ignore": True, "ignore_label": 3}, False),
        "SoftmaxOutput_ignore_valid": (
            "SoftmaxOutput", [_rand(rng, 5, 4),
                              np.array([-1, 2, 0, -1, 1], np.float32)],
            {"use_ignore": True, "normalization": "valid",
             "grad_scale": 2.0}, False),
        "LinearRegressionOutput": ("LinearRegressionOutput",
                                   [_rand(rng, 4, 3), _rand(rng, 4, 3)],
                                   {"grad_scale": 2.0}, False),
        "MAERegressionOutput": ("MAERegressionOutput",
                                [_rand(rng, 4, 3), _rand(rng, 4, 3)], {},
                                False),
        "LogisticRegressionOutput": ("LogisticRegressionOutput",
                                     [_rand(rng, 4, 3), _rand(rng, 4, 3)],
                                     {}, False),
    }


OP_CASES = sorted(_cases(np.random.RandomState(0)))


@pytest.mark.parametrize("case", OP_CASES)
def test_nd_nn_op_matches_jax(case):
    """Each nn registry op through ``mx.nd`` in both packages: every
    output, and (where it has floating inputs) the gradient of the sum of
    its first output times a fixed ramp.  Dropout outside training is the
    identity."""
    op, inputs, params, train = _cases(np.random.RandomState(0))[case]
    results = []
    for mx in (jmx, tmx):
        arrs = [mx.nd.array(a, dtype=a.dtype) for a in inputs]
        # float inputs take gradients (SoftmaxOutput's label does not)
        diff = [a for a, raw in zip(arrs, inputs)
                if raw.dtype == np.float32][:1 if op == "SoftmaxOutput"
                                             or op.endswith("RegressionOutput")
                                             else None]
        for a in diff:
            a.attach_grad()
        fn = getattr(mx.nd, op)
        with mx.autograd.record(train_mode=train):
            out = fn(*arrs, **params)
            outs = out if isinstance(out, list) else [out]
            ramp = mx.nd.array(np.linspace(
                -1, 1, outs[0].size, dtype=np.float32).reshape(outs[0].shape))
            loss = (outs[0] * ramp).sum()
        loss.backward()
        results.append((outs, [a.grad for a in diff]))
    (jouts, jgrads), (touts, tgrads) = results
    assert len(jouts) == len(touts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, what=f"{case} output {i}")
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, what=f"{case} grad {i}")
    if case == "Dropout":
        np.testing.assert_array_equal(touts[0].asnumpy(), inputs[0])


def test_dropout_op_trains_from_the_device_stream():
    """In training the Dropout op draws from the device's mx.random
    stream: a seeded call repeats, the kept share is near 1 - p, and kept
    values are scaled by 1 / (1 - p)."""
    x = tmx.nd.ones((64, 64))
    draws = []
    for _ in range(2):
        tmx.random.seed(7)
        with tmx.autograd.train_mode():
            draws.append(tmx.nd.Dropout(x, p=0.25).asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    kept = draws[0] != 0
    assert 0.7 < kept.mean() < 0.8
    np.testing.assert_allclose(draws[0][kept], 1 / 0.75)


def test_embedding_out_of_range_ids_follow_jnp_take():
    """Ids in [-V, 0) count from the end; any other id outside [0, V)
    gives a NaN row and adds nothing to the weight's gradient, as the JAX
    package's ``jnp.take`` does.  No such id reaches ``F.embedding``
    (on the card it would be a device-side assert)."""
    rng = np.random.RandomState(2)
    w = _rand(rng, 7, 3)
    ids = np.array([[0, -1, 7, 3], [-7, -8, 100, 6]], np.float32)
    got = []
    for mx in (jmx, tmx):
        weight = mx.nd.array(w)
        weight.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Embedding(mx.nd.array(ids), weight, input_dim=7,
                                  output_dim=3)
            loss = (mx.nd.where(out == out, out, mx.nd.zeros_like(out))
                    * mx.nd.array(np.arange(24, dtype=np.float32)
                                  .reshape(2, 4, 3))).sum()
        loss.backward()
        got.append((out.asnumpy(), weight.grad.asnumpy()))
    (jo, jg), (to, tg) = got
    np.testing.assert_array_equal(np.isnan(to), np.isnan(jo))
    np.testing.assert_array_equal(np.isnan(to).all(-1),
                                  [[False, False, True, False],
                                   [False, True, True, False]])
    np.testing.assert_array_equal(np.nan_to_num(to), np.nan_to_num(jo))
    np.testing.assert_array_equal(to[0, 1], w[6])
    np.testing.assert_array_equal(tg, jg)


def test_executor_forward_rebinds_inputs_at_their_shape():
    """An executor bound at data (4, 3) and given a (1, 3) batch returns
    (1, 2), as the JAX package's does (it used to broadcast the row)."""
    rng = np.random.RandomState(4)
    values = {"fc_weight": _rand(rng, 2, 3), "fc_bias": _rand(rng, 2)}
    x1 = _rand(rng, 1, 3)
    outs = []
    for mx in (jmx, tmx):
        sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                    name="fc")
        ex = sym.simple_bind(grad_req="write", data=(4, 3))
        ex.copy_params_from({k: mx.nd.array(v) for k, v in values.items()})
        assert ex.forward(data=mx.nd.array(x1))[0].shape == (1, 2)
        ex.forward(is_train=True, data=mx.nd.array(np.tile(x1, (6, 1))))
        ex.backward(mx.nd.ones((6, 2)))
        outs.append((ex.outputs[0].asnumpy(), ex.arg_dict["data"].shape,
                     ex.grad_dict["fc_weight"].asnumpy()))
    (jo, js, jg), (to, ts, tg) = outs
    assert ts == js == (6, 3)
    _close(to, jo)
    _close(tg, jg)


def test_every_nn_op_composes_in_mx_sym():
    """``mx.sym`` is generated from the same registry: every nn op (and
    its aliases) has a composer, and its shape inference runs on meta
    tensors."""
    from mxnet_tpu_torch.ops import registry
    names = ["FullyConnected", "fully_connected", "Convolution",
             "convolution", "Pooling", "pooling", "Activation", "activation",
             "BatchNorm", "batch_norm", "BatchNorm_v1", "LayerNorm",
             "Embedding", "Dropout", "softmax", "log_softmax",
             "SoftmaxOutput", "Softmax", "flash_attention",
             "_contrib_conv1x1_bn_stats", "LinearRegressionOutput",
             "MAERegressionOutput", "LogisticRegressionOutput"]
    for n in names:
        assert n in registry.REGISTRY
        assert callable(getattr(tmx.nd, n)) and callable(getattr(tmx.sym, n))
    q = tmx.sym.var("q", shape=(2, 5, 8))
    att = tmx.sym.flash_attention(q, q, q, num_heads=2, name="att")
    assert att.infer_shape()[1] == [(2, 5, 8)]
    x = tmx.sym.var("x", shape=(2, 4, 4, 3))
    y = tmx.sym._contrib_conv1x1_bn_stats(x, tmx.sym.var("w",
                                                         shape=(5, 3, 1, 1)),
                                          stride=2, name="cb")
    assert y.infer_shape()[1] == [(2, 2, 2, 5), (5,), (5,)]
