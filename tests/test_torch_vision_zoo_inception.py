"""Port parity: Inception v3 at 299 px, batch 1, against the JAX package
on the CPU, as ``tests/test_torch_vision_zoo.py`` holds the other zoo
families (its helpers, weights and tolerances): the eval forward and
``export`` / ``SymbolBlock.imports``, whose JSON has the ``_Concurrent``
cells' ``concat`` nodes, and the training-mode gradients and moving
statistics of Inception's stem conv, an A and an E cell at 35 px (its
48 layers in a training forward part the packages by more than their
rounding, see ``TRAIN_FAMILIES`` there), under the centred variance
against the JAX package and under the one-pass variance against the
float64 gradients.  Its own file keeps each zoo file under a minute on
the CPU.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5.
"""
import pytest

import mxnet_tpu_torch as tmx
from test_torch_vision_zoo import (eval_check, export_check,
                                   one_pass_check, train_check)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def test_inception_v3_eval_forward_matches_jax():
    eval_check("inception_v3")


def test_inception_cells_train_gradients_and_moving_stats_match_jax(
        monkeypatch):
    train_check("inception_cells", monkeypatch)


def test_inception_v3_export_imports_and_matches_jax_json(tmp_path):
    export_check("inception_v3", tmp_path)


def test_inception_cells_train_gradients_one_pass_variance_against_float64(
        monkeypatch):
    one_pass_check("inception_cells", monkeypatch)
