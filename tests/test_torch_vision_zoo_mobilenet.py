"""Port parity: MobileNet v1 and v2 against the JAX package on the CPU,
with the helpers, weights and checks of ``tests/test_torch_vision_zoo.py``:
``mobilenet0_25`` and ``mobilenet_v2_0_25``'s eval forwards and exports,
and the training-mode gradients and moving statistics of a few of each
family's own blocks (depthwise convolutions, ReLU6 as a clip).  Also the
local weight store: a model one package publishes loads in the other,
and a missing or corrupted file raises.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5.
"""
import os

import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from mxnet_tpu_torch.gluon.model_zoo import vision as tv
from test_torch_vision_zoo import (OUT_REL, _close, _models, eval_check,
                                   export_check, one_pass_check,
                                   train_check)

# the families of this file (FAMILIES and TRAIN_FAMILIES there): eval
# forwards and exports, training checks
EVAL = ("mobilenet0_25", "mobilenet_v2_0_25")
TRAIN = ("mobilenet_v1_blocks", "mobilenet_v2_blocks")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


@pytest.mark.parametrize("family", EVAL)
def test_zoo_eval_forward_matches_jax(family):
    eval_check(family)


@pytest.mark.parametrize("family", TRAIN)
def test_zoo_train_gradients_and_moving_stats_match_jax(family, monkeypatch):
    train_check(family, monkeypatch)


@pytest.mark.parametrize("family", TRAIN)
def test_zoo_train_gradients_one_pass_variance_against_float64(family,
                                                               monkeypatch):
    one_pass_check(family, monkeypatch)


@pytest.mark.parametrize("family", ("mobilenet_v2_blocks",))
def test_zoo_train_forward_one_pass_variance_matches_jax(family,
                                                         monkeypatch):
    train_check(family, monkeypatch, gradients=False)


@pytest.mark.parametrize("family", EVAL)
def test_zoo_export_imports_and_matches_jax_json(family, tmp_path):
    export_check(family, tmp_path)


def _publish_and_load(src_pkg, src_store, dst_vision, dst_store, tmp_path,
                      ctx):
    name = "mobilenet0_25"
    root = str(tmp_path / "store")
    jnet, tnet, x = _models(name)
    src = jnet if src_pkg == "jax" else tnet
    path = str(tmp_path / "w.params")
    src.save_parameters(path)
    stored = src_store.publish_model_file(name, path, root=root)
    assert os.path.basename(stored) == \
        f"{name}-{dst_store.short_hash(name, root=root)}.params"
    assert dst_store.list_models(root=root) == [name]
    kw = {} if ctx is None else {"ctx": ctx}
    net = dst_vision.get_model(name, pretrained=True, root=root, classes=10,
                               prefix="z_", **kw)
    return net, x, stored


def test_jax_published_model_loads_in_the_port(tmp_path):
    net, x, _ = _publish_and_load("jax", jstore, tv, tstore, tmp_path,
                                  tmx.cpu())
    jnet, _, _ = _models("mobilenet0_25")
    _close(net(tmx.nd.array(x)), jnet(jmx.nd.array(x)), OUT_REL, "loaded")


def test_port_published_model_loads_in_jax(tmp_path):
    net, x, _ = _publish_and_load("port", tstore, jv, jstore, tmp_path, None)
    _, tnet, _ = _models("mobilenet0_25")
    _close(net(jmx.nd.array(x)), tnet(tmx.nd.array(x)), OUT_REL, "loaded")


def test_store_refuses_missing_and_corrupted_files(tmp_path):
    """No network: a model not in the store raises naming
    ``publish_model_file``; a file whose sha1 changed raises."""
    root = str(tmp_path / "store")
    with pytest.raises(IOError, match="publish_model_file"):
        tv.get_model("vgg11", pretrained=True, root=root)
    src = tmp_path / "x.params"
    src.write_bytes(b"not a checkpoint")
    stored = tstore.publish_model_file("vgg11", str(src), root=root)
    with open(stored, "ab") as f:
        f.write(b"!")
    with pytest.raises(IOError, match="checksum"):
        tstore.get_model_file("vgg11", root=root)
    tstore.purge(root=root)
    assert tstore.list_models(root=root) == []
