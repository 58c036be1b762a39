"""Losses of the training slice: the ``Loss`` base with its shared
weighting epilogue and ``SoftmaxCrossEntropyLoss`` (counterparts of
``mxnet_tpu/gluon/loss.py``).  A loss returns one value per sample."""
from __future__ import annotations

from torch import nn

from ..ops import nn as F

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(nn.Module):
    def __init__(self, weight, batch_axis):
        super().__init__()
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


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``log_softmax(pred)`` against class indices
    (``sparse_label``) or a distribution of ``pred``'s shape."""

    def __init__(self, axis=-1, sparse_label=True, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label

    def forward(self, pred, label, sample_weight=None):
        logp = F.log_softmax(pred, self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -(logp * label.reshape(logp.shape)).sum(dim=self._axis,
                                                          keepdim=True)
        return self._finish(nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
