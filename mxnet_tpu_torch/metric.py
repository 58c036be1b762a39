"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``, reference
``python/mxnet/metric.py``): ``EvalMetric``, ``CompositeEvalMetric``,
``Accuracy``, ``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``,
``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``, ``Loss``,
``CustomMetric`` and ``create``.  They compute in numpy on the host, over
``asnumpy()`` of NDArrays (or tensors, or arrays), as in the reference, so
each update waits for the card."""
from __future__ import annotations

import math
from typing import Dict

import numpy as _np
import torch

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Loss", "CustomMetric", "create",
           "check_label_shapes", "np"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    def deco(klass):
        for n in names:
            _REGISTRY[n.lower()] = klass
        return klass
    return deco


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Validate label/pred counts (and shapes when ``shape``); optionally wrap
    bare arrays in lists (reference metric.py:33)."""
    if not shape:
        lshape = len(labels) if isinstance(labels, (list, tuple)) else 1
        pshape = len(preds) if isinstance(preds, (list, tuple)) else 1
    else:
        lshape, pshape = labels.shape, preds.shape
    if lshape != pshape:
        raise ValueError(f"Shape of labels {lshape} does not match shape of "
                         f"predictions {pshape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REGISTRY[metric.lower()](*args, **kwargs)


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label: Dict, pred: Dict):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_config(self):
        """Serializable metric config (reference metric.py get_config)."""
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _add(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
@alias("composite")
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def _gather(self, getter):
        names, values = [], []
        for m in self.metrics:
            n, v = getter(m)
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values

    def get(self):
        return self._gather(lambda m: m.get())

    def get_global(self):
        return self._gather(lambda m: m.get_global())


def _check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError(f"label/pred count mismatch: {len(labels)} vs {len(preds)}")


@register
@alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, (NDArray, torch.Tensor)):
            labels = [labels]
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype("int64")
            if p.ndim > l.ndim:
                p = p.argmax(axis=self.axis)
            p = p.astype("int64").reshape(-1)
            l = l.reshape(-1)
            self._add(float((p == l).sum()), len(l))


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype("int64").reshape(-1)
            if p.ndim == 1:
                # already class labels (reference metric.py num_dims==1 branch)
                self._add(float((p.astype("int64") == l).sum()), len(l))
                continue
            idx = _np.argsort(p, axis=-1)[:, -self.top_k:]
            hits = (idx == l[:, None]).any(axis=1)
            self._add(float(hits.sum()), len(l))


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    @staticmethod
    def _f1(tp, fp, fn):
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        return 2 * prec * rec / max(prec + rec, 1e-12)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).reshape(-1).astype("int64")
            ph = (p[:, 1] > 0.5).astype("int64") if p.ndim == 2 else (p > 0.5).astype("int64")
            tp = float(((ph == 1) & (l == 1)).sum())
            fp = float(((ph == 1) & (l == 0)).sum())
            fn = float(((ph == 0) & (l == 1)).sum())
            if self.average == "macro":
                # reference metric.py: macro averages per-batch F1 scores
                self.sum_metric += self._f1(tp, fp, fn)
                self.num_inst += 1
                self.global_sum_metric += self._f1(tp, fp, fn)
                self.global_num_inst += 1
            else:  # micro: one F1 over pooled counts
                self._tp += tp
                self._fp += fp
                self._fn += fn
                f1 = self._f1(self._tp, self._fp, self._fn)
                self.sum_metric = f1
                self.num_inst = 1
                self.global_sum_metric = f1
                self.global_num_inst = 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).reshape(-1).astype("int64")
            probs = p.reshape(-1, p.shape[-1])[_np.arange(l.size), l]
            if self.ignore_label is not None:
                ignore = (l == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(_np.log(_np.maximum(probs, 1e-10)).sum())
            num += l.size
        self._add(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _to_np(label), _to_np(pred)
            self._add(float(_np.abs(l.reshape(p.shape) - p).mean()) * 1, 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _to_np(label), _to_np(pred)
            self._add(float(((l.reshape(p.shape) - p) ** 2).mean()), 1)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l = _to_np(label).reshape(-1).astype("int64")
            p = _to_np(pred).reshape(l.size, -1)
            probs = p[_np.arange(l.size), l]
            self._add(float(-_np.log(probs + self.eps).sum()), l.size)


@register
@alias("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            loss = float(_to_np(pred).sum())
            self._add(loss, _to_np(pred).size)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            reval = self._feval(_to_np(label), _to_np(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self._add(m, n)
            else:
                self._add(reval, 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__, allow_extra_outputs=allow_extra_outputs)
