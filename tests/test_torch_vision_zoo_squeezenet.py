"""Port parity: SqueezeNet 1.1 against the JAX package on the CPU, with
the helpers, weights and checks of ``tests/test_torch_vision_zoo.py``:
the eval forward at 69 px (its ceil-mode pools end in partial windows,
which a test checks), the training-mode gradients and moving statistics,
and the export.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5.
"""
import pytest

import mxnet_tpu_torch as tmx
from test_torch_vision_zoo import (_models, eval_check, export_check,
                                   one_pass_check, train_check)

# the families of this file (FAMILIES and TRAIN_FAMILIES there): eval
# forwards and exports, training checks
EVAL = ("squeezenet1_1",)
TRAIN = ("squeezenet1_1",)


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


@pytest.mark.parametrize("family", EVAL)
def test_zoo_export_imports_and_matches_jax_json(family, tmp_path):
    export_check(family, tmp_path)


def test_squeezenet_full_convention_pads_the_last_window():
    """SqueezeNet's ``MaxPool2D(3, 2, ceil_mode=True)`` on a 34-wide map
    (from 69 px) has a partial last window: 16 outputs, not 15."""
    _, tnet, x = _models("squeezenet1_1")
    assert x.shape[2] == 69
    seen = []
    handle = tnet.features[1].register_forward_hook(
        lambda block, args, out: seen.append(tuple(out.shape)))
    tnet(tmx.nd.array(x))
    handle.detach()
    assert seen == [(2, 64, 17, 17)]
