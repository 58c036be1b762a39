"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``).  Its max pools take
the 'full' convention (``ceil_mode=True``): a last partial window is
padded on the high edge with -inf."""
from ...nn import (Conv2D, Dropout, Flatten, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ._base import ZooBlock, concat

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(ZooBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = Conv2D(squeeze_channels, kernel_size=1,
                              activation="relu")
        self.expand1x1 = Conv2D(expand1x1_channels, kernel_size=1,
                                activation="relu")
        self.expand3x3 = Conv2D(expand3x3_channels, kernel_size=3, padding=1,
                                activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return concat([self.expand1x1(x), self.expand3x3(x)], 1)


_FIRES = {"1.0": ["pool", (16, 64, 64), (16, 64, 64), (32, 128, 128), "pool",
                  (32, 128, 128), (48, 192, 192), (48, 192, 192),
                  (64, 256, 256), "pool", (64, 256, 256)],
          "1.1": ["pool", (16, 64, 64), (16, 64, 64), "pool",
                  (32, 128, 128), (32, 128, 128), "pool", (48, 192, 192),
                  (48, 192, 192), (64, 256, 256), (64, 256, 256)]}


class SqueezeNet(ZooBlock):
    def __init__(self, version, classes=1000, device=None, ctx=None,
                 **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, kernel_size=7, strides=2,
                                         activation="relu"))
            else:
                self.features.add(Conv2D(64, kernel_size=3, strides=2,
                                         activation="relu"))
            for item in _FIRES[version]:
                self.features.add(
                    MaxPool2D(pool_size=3, strides=2, ceil_mode=True)
                    if item == "pool" else _Fire(*item))
            self.features.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1,
                                   activation="relu"))
            self.output.add(GlobalAvgPool2D())
            self.output.add(Flatten())
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
