"""MobileNet v1 and v2 at every width multiplier (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``): depthwise 3x3
convolutions (``groups`` = channels) and 1x1 convolutions, each with
BatchNorm and ReLU (v2: ReLU6, ``clip`` to [0, 6] in the symbolic form);
v2's inverted-residual ``LinearBottleneck`` adds its input when the
stride is 1 and the widths agree."""
import torch

from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential)
from ._base import ZooBlock

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


class _RELU6(ZooBlock):
    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)

    def hybrid_forward(self, F, x):
        return F.clip(x, a_min=0.0, a_max=6.0)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm(scale=True))
    if active:
        out.add(_RELU6() if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(ZooBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(ZooBlock):
    def __init__(self, multiplier=1.0, classes=1000, device=None, ctx=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                               + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(GlobalAvgPool2D())
                self.features.add(Flatten())
            self.output = Dense(classes)
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(ZooBlock):
    def __init__(self, multiplier=1.0, classes=1000, device=None, ctx=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = ([1, 2] + [1, 2] + [1] * 2 + [2] + [1] * 3
                           + [1] * 3 + [2] + [1] * 2 + [1])
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(in_c, c, t, s,
                                                       prefix=""))
                last_channels = (int(1280 * multiplier) if multiplier > 1.0
                                 else 1280)
                _add_conv(self.features, last_channels, relu6=True)
                self.features.add(GlobalAvgPool2D())
            self.output = HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(Conv2D(classes, 1, use_bias=False,
                                       prefix="pred_"), Flatten())
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


def mobilenet1_0(**kwargs):
    return MobileNet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return MobileNet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return MobileNet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return MobileNet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return MobileNetV2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return MobileNetV2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return MobileNetV2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return MobileNetV2(0.25, **kwargs)
