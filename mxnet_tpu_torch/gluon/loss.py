"""Losses (counterparts of ``mxnet_tpu/gluon/loss.py``): the ``Loss``
base with its shared weighting epilogue, ``SoftmaxCrossEntropyLoss``,
``L2Loss`` and ``L1Loss``, which compute on tensors, and ``HuberLoss``,
``SigmoidBinaryCrossEntropyLoss``, ``LogisticLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``KLDivLoss``, ``CTCLoss``, ``TripletLoss``,
``PoissonNLLLoss``, ``CosineEmbeddingLoss`` and ``SDMLLoss``, whose one
body is the JAX loss's ``hybrid_forward(F, ...)``: over ``mx.nd`` for
tensors and NDArrays, over ``mx.sym`` for a symbolic trace.
A loss returns one value per sample (``PoissonNLLLoss`` its mean);
called with NDArrays it returns an NDArray, whose ``backward()``
differentiates the sum over the batch (the Trainer's
``step(batch_size)`` rescales by ``1/batch_size``)."""
from __future__ import annotations

import math

import numpy as np

from ..ndarray import ndarray as _nd
from ..ops import F
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "L2Loss",
           "L1Loss", "HuberLoss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "LogisticLoss", "HingeLoss", "SquaredHingeLoss",
           "KLDivLoss", "CTCLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "SDMLLoss"]

_EPS = 1e-12


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
        axes = tuple(i for i in range(loss.dim())
                     if i != self._batch_axis % loss.dim())
        if not axes:  # the batch axis alone: a trailing axis of one
            loss, axes = loss.unsqueeze(-1), (-1,)
        return F.mean(loss, axis=axes)

    def _finish_f(self, F, loss, sample_weight, weight=None):
        """:meth:`_finish` in ``F``'s ops (the symbolic-form losses)."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        w = self._weight if weight is None else weight
        if w is not None and w != 1.0:
            loss = loss * w
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def _weighted(self, F, loss, sample_weight):
        """``loss`` times ``sample_weight`` and the constant weight, not
        reduced (the per-sample losses)."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        return loss if self._weight in (None, 1.0) else loss * self._weight

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
        return self._finish(F.square(pred - _match(label, pred)),
                            sample_weight, self._weight / 2)


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


def _softplus(F, z):
    """``log(1 + eᶻ)``, stable (the softrelu activation)."""
    return F.Activation(z, act_type="softrelu")


def _like(F, ref, x):
    """``x`` in ``ref``'s shape (labels arrive flat)."""
    return F.reshape_like(x, ref)


class HuberLoss(Loss):
    """``(pred − label)²/(2·rho)`` within ``rho``, ``|pred − label| −
    rho/2`` beyond."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        a = F.abs(pred - _like(F, pred, label))
        quad = F.square(a) * (0.5 / self._rho)
        lin = a - 0.5 * self._rho
        return self._finish_f(F, F.where(a > self._rho, lin, quad),
                              sample_weight)


def _bce_logits(F, z, y, pos_weight):
    """Binary cross entropy from logits, ``(1 − y)·z + softplus(−z)``;
    ``pos_weight`` scales the positive term: ``(1 − y)·z + (1 + (pw −
    1)·y)·softplus(−z)``."""
    if pos_weight is None:
        return (1.0 - y) * z + _softplus(F, -z)
    amp = 1.0 + F.broadcast_mul(pos_weight - 1.0, y)
    return (1.0 - y) * z + amp * _softplus(F, -z)


def _bce_probs(F, p, y, pos_weight):
    """Binary cross entropy from probabilities, the logs guarded by 1e-12."""
    pos = F.log(p + _EPS) * y
    if pos_weight is not None:
        pos = F.broadcast_mul(pos, pos_weight)
    return -(pos + F.log(1.0 - p + _EPS) * (1.0 - y))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (``pred`` itself with
    ``from_sigmoid``) against labels in {0, 1}; ``pos_weight`` weighs the
    positive class."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        y = _like(F, pred, label)
        bce = (_bce_probs if self._from_sigmoid else _bce_logits)(
            F, pred, y, pos_weight)
        return self._finish_f(F, bce, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class LogisticLoss(Loss):
    """Logistic loss of ``pred`` against ±1 labels (``'signed'``) or
    {0, 1} (``'binary'``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be signed or binary, got "
                             f"{label_format}")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        y = _like(F, pred, label)
        if self._label_format == "signed":
            y = (y + 1.0) * 0.5
        return self._finish_f(F, _bce_logits(F, pred, y, None), sample_weight)


class HingeLoss(Loss):
    """``max(0, margin − pred·label)`` over ±1 labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        slack = F.relu(self._margin - pred * _like(F, pred, label))
        return self._finish_f(F, slack, sample_weight)


class SquaredHingeLoss(Loss):
    """``max(0, margin − pred·label)²`` over ±1 labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        slack = F.relu(self._margin - pred * _like(F, pred, label))
        return self._finish_f(F, F.square(slack), sample_weight)


class KLDivLoss(Loss):
    """``label·(log(label) − log_softmax(pred))``; ``pred`` is already in
    log space with ``from_logits`` (the default)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        div = label * (F.log(label + _EPS) - logp)
        return self._finish_f(F, div, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``CTCLoss`` op (blank
    class 0; a label ends at its first id ≤ 0 unless ``label_lengths``
    says)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"layout must be NTC or TNC, got {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"label_layout must be NT or TN, got "
                             f"{label_layout}")
        super().__init__(weight, None, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        args = [pred, label] + [a for a in (pred_lengths, label_lengths)
                                if a is not None]
        nll = F.CTCLoss(*args, use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None,
                        blank_label="first")
        return self._weighted(F, nll, sample_weight)


class TripletLoss(Loss):
    """``max(0, margin + ‖pred − positive‖² − ‖pred − negative‖²)`` per
    sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        d_pos = F.square(_like(F, pred, positive) - pred)
        d_neg = F.square(_like(F, pred, negative) - pred)
        gap = F.sum(d_pos - d_neg, axis=self._batch_axis, exclude=True)
        return self._weighted(F, F.relu(gap + self._margin), sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of ``label`` under the rate
    ``exp(pred)`` (``pred`` itself without ``from_logits``), with
    Stirling's term where label > 1 under ``compute_full``; reduced to its
    mean over everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       epsilon=1e-08):
        y = _like(F, pred, label)
        if self._from_logits:
            nll = F.exp(pred) - y * pred
        else:
            nll = pred - y * F.log(pred + epsilon)
        if self._compute_full:
            stirling = (y * F.log(y + _EPS) - y
                        + 0.5 * F.log(2.0 * math.pi * (y + _EPS)))
            nll = nll + stirling * (y > 1)
        return F.mean(self._weighted(F, nll, sample_weight))


class CosineEmbeddingLoss(Loss):
    """``1 − cos(input1, input2)`` for label 1, ``max(0, cos − margin)``
    otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        dot = F.sum(input1 * input2, axis=-1)
        denom = F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + _EPS
        cos = dot / denom
        label = label.reshape(shape=(-1,))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return self._weighted(F, loss, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: the KL divergence between a
    label-smoothed identity and the softmax over the negated pairwise
    distances of ``x1``'s and ``x2``'s rows (NDArrays only: the target's
    size is the batch's)."""

    def __init__(self, smoothing_parameter=0.3, weight=1., batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def _smoothed_identity(self, n, ctx):
        off = self.smoothing_parameter / max(n - 1, 1)
        tgt = np.full((n, n), off, dtype="float32")
        np.fill_diagonal(tgt, 1.0 - self.smoothing_parameter)
        return _nd.array(tgt, ctx=ctx)

    def hybrid_forward(self, F, x1, x2):
        n = x1.shape[0]
        dist = F.norm(F.expand_dims(x1, 1) - F.expand_dims(x2, 0), axis=2)
        logprob = F.log(F.softmax(-dist, axis=1) + _EPS)
        return self.kl_loss(logprob, self._smoothed_identity(n, x1.context))
