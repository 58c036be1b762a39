"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``): the same layers, names and
initializers (Xavier convolutions, Normal dense layers).  The first
``Dense`` infers its width from the input (512·7·7 at 224 px)."""
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout,
                   HybridSequential, MaxPool2D)
from ._base import ZooBlock

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(ZooBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 device=None, ctx=None, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal"))
            self.features.add(Dropout(0.5))
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal"))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes, weight_initializer="normal")
        self._defer_to(device, ctx)

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(Conv2D(filters[i], kernel_size=3, padding=1,
                                      weight_initializer="xavier"))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, ctx=ctx, **kwargs)
    if pretrained:
        from . import load_pretrained
        batch_norm = kwargs.get("batch_norm", False)
        load_pretrained(net, f"vgg{num_layers}{'_bn' if batch_norm else ''}",
                        root=root, ctx=ctx)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
