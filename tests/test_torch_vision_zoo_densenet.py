"""Port parity: DenseNet (16 initial features, growth 8, two blocks of
2 layers) against the JAX package on the CPU, with the helpers, weights
and checks of ``tests/test_torch_vision_zoo.py``: the eval forward, the
training-mode gradients and moving statistics, and the export, whose
JSON has the dense blocks' concatenations.  Also ResNet v2 with
bottleneck blocks (widths 8/16/32), which keeps that file under a
minute: its eval forward, gradients and moving statistics.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5.
"""
import pytest

import mxnet_tpu_torch as tmx
from test_torch_vision_zoo import (eval_check, export_check,
                                   one_pass_check, train_check)

# the families of this file (FAMILIES and TRAIN_FAMILIES there): eval
# forwards and exports, training checks
EVAL = ("densenet_small", "resnet_v2_bottleneck")
TRAIN = EVAL


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


@pytest.mark.parametrize("family", ("densenet_small",))
def test_zoo_export_imports_and_matches_jax_json(family, tmp_path):
    export_check(family, tmp_path)
