"""Losses: the ``Loss`` base with its shared weighting epilogue,
``SoftmaxCrossEntropyLoss``, ``L2Loss`` and ``L1Loss`` (counterparts of
``mxnet_tpu/gluon/loss.py``), as
:class:`~mxnet_tpu_torch.gluon.block.HybridBlock` s computing on tensors.
A loss returns one value per sample; called with NDArrays it returns an
NDArray, whose ``backward()`` differentiates the sum over the batch (the
Trainer's ``step(batch_size)`` rescales by ``1/batch_size``)."""
from __future__ import annotations

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "L2Loss",
           "L1Loss"]


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, loss, sample_weight, weight=None):
        """sample_weight (broadcast) -> constant weight -> mean over every
        axis but the batch axis."""
        if sample_weight is not None:
            loss = loss * sample_weight
        w = self._weight if weight is None else weight
        if w is not None and w != 1.0:
            loss = loss * w
        axes = [i for i in range(loss.dim())
                if i != self._batch_axis % loss.dim()]
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


def _match(label, pred):
    """``label`` in ``pred``'s shape (labels arrive flat)."""
    return label.reshape(pred.shape)


class L2Loss(Loss):
    """Half the squared error: ``weight/2 · (pred − label)²``, averaged per
    sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        err = pred - _match(label, pred)
        return self._finish(err.square(), sample_weight, self._weight / 2)


class L1Loss(Loss):
    """Absolute error, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        return self._finish((pred - _match(label, pred)).abs(), sample_weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``log_softmax(pred)`` (``pred`` itself with
    ``from_logits``) against class indices (``sparse_label``) or a
    distribution of ``pred``'s shape."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else F.log_softmax(pred, self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -(logp * label.reshape(logp.shape)).sum(dim=self._axis,
                                                          keepdim=True)
        return self._finish(nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
