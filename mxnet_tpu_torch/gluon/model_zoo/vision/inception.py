"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; 299 px inputs): the
A-E cells of conv + BN (eps 1e-3) + ReLU branches concatenated on the
channels, the convolutions named by the cells' prefixes (``A1_``,
``C2_``...).  A cell is a ``_Concurrent``: its ``forward`` concatenates
its branches' tensors, or composes ``concat`` over their Symbols when
``export`` traces it.  The branch pools are ``AvgPool2D(3, 1, 1)``, whose
divisor counts the padding (``count_include_pad``), and
``MaxPool2D(3, 2)``; the head pools 8x8 to 1x1 before the ``Dense``,
which infers its width (2048 at 299 px)."""
from __future__ import annotations

from ... import nn
from ._base import ZooBlock, concat

__all__ = ["Inception3", "inception_v3"]


class _Concurrent(nn.HybridSequential):
    """The children on the same input, their outputs concatenated on
    ``axis``."""

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def forward(self, x, *args):
        return concat([child(x) for child in self._modules.values()],
                      self._axis)


def _conv(channels, kernel, stride=1, padding=0, prefix=None):
    out = nn.HybridSequential(prefix=prefix)
    with out.name_scope():
        out.add(nn.Conv2D(channels, kernel, strides=stride, padding=padding,
                          use_bias=False))
        out.add(nn.BatchNorm(epsilon=0.001))
        out.add(nn.Activation("relu"))
    return out


def _branch(use_pool, *convs):
    seq = nn.HybridSequential(prefix="")
    with seq.name_scope():
        if use_pool == "avg":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif use_pool == "max":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        for (ch, kernel, stride, pad) in convs:
            seq.add(_conv(ch, kernel, stride, pad))
    return seq


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_branch(None, (64, 1, 1, 0)))
        out.add(_branch(None, (48, 1, 1, 0), (64, 5, 1, 2)))
        out.add(_branch(None, (64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)))
        out.add(_branch("avg", (pool_features, 1, 1, 0)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_branch(None, (384, 3, 2, 0)))
        out.add(_branch(None, (64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)))
        out.add(_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_branch(None, (192, 1, 1, 0)))
        out.add(_branch(None, (c, 1, 1, 0), (c, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0))))
        out.add(_branch(None, (c, 1, 1, 0), (c, (7, 1), 1, (3, 0)),
                        (c, (1, 7), 1, (0, 3)), (c, (7, 1), 1, (3, 0)),
                        (192, (1, 7), 1, (0, 3))))
        out.add(_branch("avg", (192, 1, 1, 0)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_branch(None, (192, 1, 1, 0), (320, 3, 2, 0)))
        out.add(_branch(None, (192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)))
        out.add(_branch("max"))
    return out


def _split_3x3(in_conv_widths):
    """A 1x1 (and 3x3) conv into two concurrent 1x3 and 3x1 branches."""
    pair = _Concurrent(prefix="")
    with pair.name_scope():
        pair.add(_branch(None, (384, (1, 3), 1, (0, 1))))
        pair.add(_branch(None, (384, (3, 1), 1, (1, 0))))
    mix = nn.HybridSequential(prefix="")
    with mix.name_scope():
        for ch, kernel, pad in in_conv_widths:
            mix.add(_conv(ch, kernel, 1, pad))
        mix.add(pair)
    return mix


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_branch(None, (320, 1, 1, 0)))
        out.add(_split_3x3([(384, 1, 0)]))
        out.add(_split_3x3([(448, 1, 0), (384, 3, 1)]))
        out.add(_branch("avg", (192, 1, 1, 0)))
    return out


class Inception3(ZooBlock):
    def __init__(self, classes=1000, device=None, ctx=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(_conv(32, 3, 2, 0))
                self.features.add(_conv(32, 3, 1, 0))
                self.features.add(_conv(64, 3, 1, 1))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(_conv(80, 1, 1, 0))
                self.features.add(_conv(192, 3, 1, 0))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(_make_A(32, "A1_"))
                self.features.add(_make_A(64, "A2_"))
                self.features.add(_make_A(64, "A3_"))
                self.features.add(_make_B("B_"))
                self.features.add(_make_C(128, "C1_"))
                self.features.add(_make_C(160, "C2_"))
                self.features.add(_make_C(160, "C3_"))
                self.features.add(_make_C(192, "C4_"))
                self.features.add(_make_D("D_"))
                self.features.add(_make_E("E1_"))
                self.features.add(_make_E("E2_"))
                self.features.add(nn.AvgPool2D(pool_size=8))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, classes=1000, ctx=None, root=None,
                 **kwargs):
    net = Inception3(classes=classes, ctx=ctx, **kwargs)
    if pretrained:
        from . import load_pretrained
        load_pretrained(net, "inceptionv3", root=root, ctx=ctx)
    return net
