"""Port parity: the device and config layer against mxnet_tpu's.

The knob registry (every ``env.declare`` of ``mxnet_tpu/base.py`` but the
compile cache's and the elastic trainer's, with the same default),
``TShape``, ``AttrScope`` stamping symbols (the symbol JSON equal to the
JAX package's), ``cpu_pinned`` and ``gpu_memory_info``, ``mx.util``,
``mx.registry``, ``mx.log`` and ``Operator.mutates``.  Everything here is
exact: names, defaults, shapes, JSON and dtypes.
"""
import logging
import re
from pathlib import Path

import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase
from mxnet_tpu import log as jlog
from mxnet_tpu import registry as jregistry
from mxnet_tpu import util as jutil
from mxnet_tpu.ops import registry as jops_registry
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import log as tlog
from mxnet_tpu_torch import registry as tregistry
from mxnet_tpu_torch import util as tutil
from mxnet_tpu_torch.ops import registry as tops_registry
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

# knobs whose modules wait for a later slice: the compile cache (ROADMAP
# A14)
LATER = {"MXNET_COMPILE_CACHE", "MXNET_COMPILE_CACHE_GB",
         "MXNET_COMPILE_CACHE_MIN_S", "MXNET_COMPILE_CACHE_SALT",
         "MXNET_COMPILE_CACHE_SIGMAP", "MXNET_COMPILE_CACHE_VERIFY"}
JAX_KNOBS = sorted(set(re.findall(
    r'env\.declare\(\s*"([A-Z_0-9]+)"',
    (Path(jbase.__file__)).read_text())))


@pytest.mark.parametrize("name", JAX_KNOBS)
def test_every_jax_knob_is_declared_with_its_default(name):
    if name in LATER:
        assert name not in tbase.env
        return
    assert name in tbase.env, name
    assert tbase.env._flags[name].default == jbase.env._flags[name].default
    assert tbase.env._flags[name].typ is jbase.env._flags[name].typ
    assert getattr(tbase.env, name) == getattr(jbase.env, name)
    assert tbase.env._flags[name].doc


def test_knobs_read_live_and_document_themselves(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "256")
    assert tbase.env.MXNET_FLASH_BLOCK_Q == jbase.env.MXNET_FLASH_BLOCK_Q \
        == 256
    doc = tbase.env.doc()
    assert "MXNET_KERNEL_BACKEND (default 'auto')" in doc
    assert "Not read by the port's CUDA kernels" in tbase.env._flags[
        "MXNET_FLASH_BLOCK_K"].doc


@pytest.mark.parametrize("dims", [None, (2, 3), (2, None, 4), (-1, 5), ()])
def test_tshape_matches_jax(dims):
    j, t = jbase.TShape(dims), tbase.TShape(dims)
    assert tuple(t) == tuple(j)
    assert t.is_known == j.is_known and t.ndim_known == j.ndim_known
    if j.is_known:
        assert t.size == j.size
    else:
        with pytest.raises(MXNetError):
            t.size


@pytest.mark.parametrize("a,b", [((2, -1), (-1, 3)), ((2, 3), (2, 3)),
                                 ((2, 3), (2, 4)), ((2,), (2, 3))])
def test_tshape_merge_matches_jax(a, b):
    try:
        want = tuple(jbase.TShape(a).merge(jbase.TShape(b)))
    except jbase.MXNetError:
        with pytest.raises(MXNetError):
            tbase.TShape(a).merge(tbase.TShape(b))
        return
    assert tuple(tbase.TShape(a).merge(tbase.TShape(b))) == want


def _scoped_symbol(mx, names):
    names.reset()
    with mx.AttrScope(group="stage1", lr_mult="0.5"):
        data = mx.sym.var("data")
        with mx.AttrScope(group="stage2"):
            fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc1")
    return mx.sym.Activation(fc, act_type="relu", name="relu1")


def test_attr_scope_stamps_the_symbol_json_like_jax():
    """Variables take the scope's attributes as attrs, op nodes as
    ``__attr_<k>__``; nested scopes merge, the inner one winning; the JSON
    equals the JAX package's."""
    jsym = _scoped_symbol(jmx, JNames)
    tsym = _scoped_symbol(tmx, TNames)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.attr_dict() == jsym.attr_dict()
    fc = tsym.get_internals()["fc1_output"]
    assert fc.list_attr()["group"] == "stage2"
    assert fc.list_attr()["lr_mult"] == "0.5"
    # the stamps never reach the op: the symbol still evaluates
    exe = tsym.simple_bind(tmx.cpu(), data=(2, 3))
    assert exe.forward()[0].shape == (2, 4)


def test_attr_scope_refuses_non_strings_and_restores():
    for mx in (jmx, tmx):
        with pytest.raises(ValueError):
            mx.AttrScope(group=1)
    with tmx.AttrScope(a="1"):
        pass
    assert tmx.attribute.current().get(None) == {}


def test_cpu_pinned_context_and_gpu_memory_info():
    ctx = tmx.cpu_pinned(0)
    assert repr(ctx) == repr(jmx.cpu_pinned(0)) == "cpu_pinned(0)"
    assert ctx.torch_device() == torch.device("cpu")
    a = tmx.nd.ones((2, 3), ctx=ctx)
    assert a.context == ctx and a._data.device.type == "cpu"
    # pinned where a card exists to pin for
    assert a._data.is_pinned() == torch.cuda.is_available()
    if not torch.cuda.is_available():
        # no card: the port refuses where the JAX package reports (0, 0)
        with pytest.raises(MXNetError):
            tmx.gpu_memory_info(0)


def test_util_matches_jax():
    assert tutil.get_gpu_count() == (torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0)
    for u in (jutil, tutil):
        with pytest.raises(ValueError):
            u.get_cuda_compute_capability(
                (jmx if u is jutil else tmx).cpu())
    for u in (jutil, tutil):
        assert not u.is_np_shape() and not u.is_np_array()
        with u.np_shape(True):
            assert u.is_np_shape()
            with u.np_array(True):
                assert u.is_np_array()
        assert not u.is_np_shape() and not u.is_np_array()
        u.set_np()
        assert u.is_np_shape() and u.is_np_array()
        u.reset_np()
        assert not u.is_np_shape()

        @u.use_np
        def inside():
            return u.is_np_shape(), u.is_np_array()
        assert inside() == (True, True)
    assert sorted(tutil.__all__) == sorted(set(jutil.__all__)
                                           | {"get_cuda_compute_capability"})


def test_util_kwarg_checks_match_jax():
    for u in (jutil, tutil):
        f = u.wrap_np_unary_func(lambda x, out=None: x)
        assert f(3) == 3
        with pytest.raises(TypeError):
            f(3, bogus=1)
        with pytest.raises(NotImplementedError):
            f(3, casting="unsafe")


def test_registry_factories_match_jax():
    made = {}
    for name, reg in (("jax", jregistry), ("port", tregistry)):
        class Base:
            pass

        class Thing(Base):
            def __init__(self, size=1):
                self.size = size
        register = reg.get_register_func(Base, "thing")
        alias = reg.get_alias_func(Base, "thing")
        create = reg.get_create_func(Base, "thing")
        register(Thing)
        alias("other")(Thing)
        made[name] = (create("thing", size=3).size,
                      create('["other", {"size": 4}]').size,
                      create('{"thing": "thing", "size": 5}').size,
                      sorted(reg.get_registry(Base)))
        with pytest.raises(Exception):
            create("missing")
    assert made["port"] == made["jax"]


def test_log_matches_jax(tmp_path):
    lines = {}
    for name, lg in (("jax", jlog), ("port", tlog)):
        path = tmp_path / f"{name}.log"
        logger = lg.get_logger(f"cfg_test_{name}", filename=str(path),
                               level=lg.INFO)
        logger.info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
        lines[name] = path.read_text().strip()
    for name, line in lines.items():
        assert line.startswith("I") and line.endswith("] hello 7"), line
    assert tlog.getLogger is tlog.get_logger
    assert (tlog.DEBUG, tlog.INFO, tlog.WARNING, tlog.ERROR) == (
        logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR)


def test_operator_mutates_like_jax():
    for reg in (jops_registry, tops_registry):
        op = reg.Operator("_cfg_probe", lambda x, y: x, nin=2)
        assert op.mutates == ()
        op = reg.Operator("_cfg_probe", lambda x, y: x, nin=2,
                          mutates=[0])
        assert op.mutates == (0,)
    assert tops_registry.get("sgd_update").mutates == \
        jops_registry.get("sgd_update").mutates


def test_top_level_names():
    for name in ("AttrScope", "amp", "util", "registry", "log", "cpu_pinned",
                 "gpu_memory_info"):
        assert hasattr(tmx, name), name
    assert tmx.amp.scale_loss is tmx.contrib.amp.scale_loss
