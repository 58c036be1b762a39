"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``): dense blocks whose
layers (BN, ReLU, 1x1 conv, BN, ReLU, 3x3 conv) concatenate their output
to their input, and transitions (BN, ReLU, 1x1 conv, 2x2 average pool)
that halve the width.  A layer's ``dropout`` draws its mask in training
from the layer's ``generator`` when one is set, else from the device's
stream (``mx.random``), which a CUDA graph over the net registers."""
from .... import random as _random
from ....ops import F as _ops
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ._base import ZooBlock, concat

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseBlockLayer(ZooBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(bn_size * growth_rate, kernel_size=1,
                             use_bias=False))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(growth_rate, kernel_size=3, padding=1,
                             use_bias=False))
        self.dropout = dropout
        self.generator = None

    def forward(self, x):
        out = self.body(x)
        if self.dropout and self.training:
            gen = self.generator or _random.device_generator(out.device)
            out = _ops.dropout(out, self.dropout, True, gen)
        return concat([x, out], 1)

    def hybrid_forward(self, F, x):
        out = self.body(x)
        if self.dropout:
            out = F.Dropout(out, p=self.dropout)
        return F.concat(x, out, dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseBlockLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm())
    out.add(Activation("relu"))
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(ZooBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, device=None, ctx=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features = num_features // 2
                    self.features.add(_make_transition(num_features))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _get(num_layers, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return _get(121, **kwargs)


def densenet161(**kwargs):
    return _get(161, **kwargs)


def densenet169(**kwargs):
    return _get(169, **kwargs)


def densenet201(**kwargs):
    return _get(201, **kwargs)
