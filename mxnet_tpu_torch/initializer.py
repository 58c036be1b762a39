"""Parameter initializers (counterpart of ``mxnet_tpu/initializer.py``,
reference ``python/mxnet/initializer.py``).

The reference's surface: a registry (``create('xavier')``, the names
``'uniform'``, ``'normal'``, ``'xavier'``, ``'zeros'``, ``'ones'`` and the
class names), :class:`InitDesc`, and ``init(desc, arr)``, which picks the
rule by the parameter's name: a name ending in ``weight`` draws, ``bias``
and ``beta`` and the moving mean are zero, ``gamma`` and the moving
variance one, whatever the initializer.  ``arr`` is an NDArray or a torch
tensor and is filled in place (a parameter's array shares the module's
tensor).  The draws come from the stream of ``arr``'s device in
:mod:`~mxnet_tpu_torch.random`, which ``mx.random.seed`` restarts.

The training slices' form stays beside it:

- ``init(tensor, gen)`` applies the initializer's own rule to ``tensor``
  with the generator ``gen``, whatever its name;
- :func:`initialize` fills a whole module with one generator, as the JAX
  package's ``collect_params().initialize()`` does: each Gluon parameter
  from the initializer it names (``None`` meaning ``Uniform(0.07)``), by
  name as above; ``nn.Linear`` and ``nn.Embedding`` weights from
  ``Uniform(0.07)``; the tensors a plain module lists in its
  ``initializers`` dict from its entry; other tensors (RMSNorm's ones, the
  RoPE tables) keep their values.

Draws are made in float32 and cast to the tensor's dtype, as in the JAX
package.  The streams differ from JAX's threefry, so tests copy weights
across instead of comparing draws.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from . import random as _random

__all__ = ["Initializer", "register", "create", "InitDesc", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "Mixed", "Load", "LSTMBias", "FusedRNN",
           "initialize"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name, or ``None``
    (``Uniform(0.07)``)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform(0.07)
    if isinstance(init, str):
        name = init.lower()
        if name not in _REGISTRY:
            raise ValueError(f"unknown initializer {init!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[name](**kwargs)
    raise TypeError(init)


class InitDesc(str):
    """A parameter's name with attributes (reference ``InitDesc``); an
    ``__init__`` attribute names the initializer to use instead."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _tensor_of(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else arr._data


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr=None):
        """``init(desc, arr)``: fill ``arr`` by the rule ``desc``'s name
        picks, from the device's stream.  ``init(tensor, gen)``: apply this
        initializer's own rule to ``tensor`` with ``gen``."""
        if isinstance(desc, torch.Tensor):
            with torch.no_grad():
                self._init_weight(None, desc, arr)
            return
        t = _tensor_of(arr)
        self._fill(desc, t, _random.device_generator(t.device))
        if not isinstance(arr, torch.Tensor):
            arr._version += 1

    @torch.no_grad()
    def _fill(self, desc, t: torch.Tensor, gen) -> None:
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init_name = desc.attrs.get("__init__", "")
        if init_name:
            create(init_name)._init_weight(desc, t, gen)
            return
        name = str(desc).lower()
        if name.endswith("weight"):
            self._init_weight(desc, t, gen)
        elif name.endswith("bias"):
            self._init_bias(desc, t, gen)
        elif name.endswith("gamma"):
            self._init_gamma(desc, t, gen)
        elif name.endswith("beta"):
            self._init_beta(desc, t, gen)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, t, gen)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, t, gen)
        else:
            self._init_default(desc, t, gen)

    def _init_zero(self, _, t, gen):
        t.fill_(0.0)

    def _init_one(self, _, t, gen):
        t.fill_(1.0)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, desc, t, gen):
        raise NotImplementedError

    def _init_default(self, desc, t, gen):
        self._init_weight(desc, t, gen)

    def dumps(self) -> str:
        """JSON ``[name, kwargs]``; ``create(*json.loads(s))`` rebuilds it."""
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, _, t, gen):
        t.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, _, t, gen):
        t.fill_(1.0)


@register
class Constant(Initializer):
    """A scalar or an array broadcast onto the tensor."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, t, gen):
        v = self.value
        v = v._data if hasattr(v, "_data") else np.asarray(v)
        t.copy_(torch.as_tensor(v))


def _uniform(t, scale, gen):
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.uniform_(-scale, scale, generator=gen)
    t.copy_(draw)


def _normal(t, sigma, gen):
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.normal_(0.0, sigma, generator=gen)
    t.copy_(draw)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = float(scale)

    def _init_weight(self, _, t, gen):
        _uniform(t, self.scale, gen)


@register
class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = float(sigma)

    def _init_weight(self, _, t, gen):
        _normal(t, self.sigma, gen)


@register
class Orthogonal(Initializer):
    """An orthogonal matrix (Saxe et al.) times ``scale``: the SVD of a
    ``[shape[0], prod(shape[1:])]`` draw, U(-1, 1) (``rand_type
    'uniform'``) or N(0, 1) (``'normal'``), from the generator given;
    rows or columns orthonormal, whichever the shape allows."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, t, gen):
        nout = t.shape[0]
        nin = int(np.prod(t.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        t.copy_(self.scale * q.reshape(t.shape))


@register
class Xavier(Initializer):
    """Glorot: ``scale = sqrt(magnitude / factor)`` with the fans
    ``shape[1]·prod(shape[2:])`` (in) and ``shape[0]·prod(shape[2:])``
    (out), ``factor`` their mean (``'avg'``), ``'in'`` or ``'out'``; then
    U(-scale, scale) (``rnd_type='uniform'``) or N(0, scale²)
    (``'gaussian'``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, t, gen):
        shape = t.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _uniform(t, scale, gen)
        elif self.rnd_type == "gaussian":
            _normal(t, scale, gen)
        else:
            raise ValueError(f"Xavier: unknown rnd_type {self.rnd_type!r}")


@register
class MSRAPrelu(Xavier):
    """He et al.: Gaussian Xavier with magnitude ``2 / (1 + slope²)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of an ``[..., h, w]`` deconvolution
    weight, the same for every channel pair."""

    def _init_weight(self, _, t, gen):
        shape = t.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        t.copy_(torch.from_numpy(w.astype(np.float32).reshape(shape)))


@register
class Mixed(Initializer):
    """The initializer of the first pattern that matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def _fill(self, desc, t, gen):
        for prog, init in self.map:
            if prog.match(str(desc)):
                create(init)._fill(desc, t, gen)
                return
        raise ValueError(f"parameter {desc} did not match any pattern")


@register
class Load(Initializer):
    """Each parameter from ``param`` by its name (``arg:``/``aux:``
    prefixes dropped; NDArrays, tensors or arrays), else from
    ``default_init``; a name in neither raises."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def _fill(self, desc, t, gen):
        name = str(desc)
        if name in self.param:
            v = self.param[name]
            v = v._data if hasattr(v, "_data") else torch.as_tensor(
                np.asarray(v))
            t.copy_(v)
        elif self.default_init is not None:
            create(self.default_init)._fill(desc, t, gen)
        else:
            raise ValueError(f"no initialization for {name}")


# the reference's registry aliases
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One
_REGISTRY["gaussian"] = Normal


@register
class LSTMBias(Initializer):
    """A packed ``[i, f, c, o]`` LSTM bias: zeros but the forget gate's
    quarter, ``forget_bias`` (the variable's ``__forget_bias__``
    attribute when it has one)."""

    def __init__(self, forget_bias=1.0, **kwargs):
        super().__init__(forget_bias=forget_bias, **kwargs)
        self._forget_bias = forget_bias

    def _init_weight(self, desc, t, gen):
        fb = self._forget_bias
        if isinstance(desc, InitDesc):
            fb = float(desc.attrs.get("__forget_bias__", fb))
        n = t.shape[0]
        if n % 4:
            raise ValueError("LSTMBias expects a packed 4*num_hidden bias")
        v = torch.zeros(n)
        v[n // 4:n // 2] = fb
        t.copy_(v)

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class FusedRNN(Initializer):
    """The fused RNN cell's initializer: an LSTM's biases get
    :class:`LSTMBias` with ``forget_bias``, every other tensor ``init``
    (or the global initializer of its ``InitDesc``).  As in the JAX
    package the cell keeps its gates' tensors apart, so nothing is
    unpacked."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            import json
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._mode = mode
        self._forget_bias = forget_bias

    def _fill(self, desc, t, gen):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if self._mode == "lstm" and str(desc).lower().endswith("bias"):
            # a fresh desc: the cell's own __forget_bias__ attribute must
            # not override this initializer's
            LSTMBias(forget_bias=self._forget_bias)._init_weight(
                InitDesc(str(desc)), t, gen)
        elif self._init is not None:
            self._init._fill(desc, t, gen)
        elif desc.global_init is not None:
            create(desc.global_init)._fill(desc, t, gen)
        else:
            super()._fill(desc, t, gen)


def _uninitialized(t) -> bool:
    return isinstance(t, nn.parameter.UninitializedTensorMixin)


@torch.no_grad()
def initialize(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill ``module``'s tensors as the JAX package's ``initialize()``
    does (see the module docstring), with the generator ``gen``, in module
    order; returns ``module``.  Parameters whose shape waits for a first
    forward are left alone."""
    default = Uniform(0.07)
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Embedding)):
            default(sub.weight, gen)
        for name, p in getattr(sub, "_reg_params", {}).items():
            t = getattr(sub, name, None)
            if t is None or _uninitialized(t):
                continue
            init = default if p.init is None else create(p.init)
            init._fill(InitDesc(p.name), t, gen)
            p._initialized = True
        for name, init in getattr(sub, "initializers", {}).items():
            tensor = getattr(sub, name)
            if tensor is not None:
                (init or default)(tensor, gen)
    return module
