"""ResNet v1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``): ``BasicBlockV1``,
``BottleneckV1``, ``ResNetV1`` and ``resnet{18,34,50,101,152}_v1``.

The same blocks built in the same name scopes and order as the JAX
package's, so ``collect_params()`` gives the same names
(``resnetv10_stage1_conv0_weight``), structural names
(``features.4.0.body.0.weight``) agree, and ``state_dict()`` lists the
JAX model's ``collect_params()`` in order.  v1 puts a bottleneck's stride
on its first 1x1 conv.  Under ``MXNET_TPU_FUSE_CONV_BN=1`` (read when a
block is built, as in the JAX package) each bottleneck 1x1 conv + BN pair
is one ``FusedConv1x1BN``, which drops the conv bias BN cancels; otherwise
the body's 1x1 convs keep their bias and the downsample conv has none.
The JAX package leaves most input widths to deferred init; here every
layer is built with its width, computed from the model's own arguments
(images have 3 channels), so the tensors exist as soon as the model does,
on ``device`` (or ``ctx``; default the card).  Each block's
``hybrid_forward`` is the JAX block's symbolic form (the residual
``broadcast_add`` and ``Activation``), which ``export`` traces.  ResNet
v2, ``thumbnail`` and pretrained weights wait for later slices.
"""
from __future__ import annotations

import torch

from ....base import MXNetError, env
from ....context import resolve_device
from ...block import HybridBlock
from ...contrib.nn import FusedConv1x1BN
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, device):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, device=device)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, device))
        self.body.add(BatchNorm(in_channels=channels, device=device))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, device))
        self.body.add(BatchNorm(in_channels=channels, device=device))
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels,
                                       device=device))
            self.downsample.add(BatchNorm(in_channels=channels,
                                          device=device))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)

    def hybrid_forward(self, F, x):
        return _residual(F, self, x)


def _residual(F, block, x):
    """``relu(body(x) + residual)``, the body composed first, as the JAX
    blocks do."""
    out = block.body(x)
    residual = x if block.downsample is None else block.downsample(x)
    return F.Activation(out + residual, act_type="relu")


def _conv1x1_bn(seq, channels, stride, relu, in_channels, use_bias=True,
                device=None):
    """1x1 conv + BN (+ ReLU) into ``seq``: one ``FusedConv1x1BN`` under
    ``MXNET_TPU_FUSE_CONV_BN=1``, else the plain layers."""
    if env.MXNET_TPU_FUSE_CONV_BN:
        seq.add(FusedConv1x1BN(channels, in_channels=in_channels,
                               strides=stride, relu=relu, device=device))
        return
    seq.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=use_bias,
                   in_channels=in_channels, device=device))
    seq.add(BatchNorm(in_channels=channels, device=device))
    if relu:
        seq.add(Activation("relu"))


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        mid = channels // 4
        self.body = HybridSequential(prefix="")
        _conv1x1_bn(self.body, mid, stride, True, in_channels, device=device)
        self.body.add(_conv3x3(mid, 1, mid, device))
        self.body.add(BatchNorm(in_channels=mid, device=device))
        self.body.add(Activation("relu"))
        _conv1x1_bn(self.body, channels, 1, False, mid, device=device)
        if downsample:
            self.downsample = HybridSequential(prefix="")
            _conv1x1_bn(self.downsample, channels, stride, False, in_channels,
                        use_bias=False, device=device)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)

    def hybrid_forward(self, F, x):
        return _residual(F, self, x)


class ResNetV1(HybridBlock):
    """ResNet v1: a 7x7/2 conv, BN, ReLU and 3x3/2 max pool, then
    ``len(layers)`` stages of ``block`` (stride 2 from the second), global
    average pooling and a ``Dense`` head.  Built on ``device`` (or
    ``ctx``; default ``cuda``, raising without CUDA) with the tensors
    allocated: fill them with ``initialize()`` (or
    :func:`~mxnet_tpu_torch.initializer.initialize`) or load them."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None, ctx=None, **kwargs):
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{channels}")
        if thumbnail:
            raise MXNetError("ResNetV1: thumbnail is not ported")
        if device is None and ctx is not None:
            device = ctx.torch_device()
        dev = resolve_device(device)
        super().__init__(device=dev, **kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                     in_channels=_IMAGE_CHANNELS, device=dev))
            self.features.add(BatchNorm(in_channels=channels[0], device=dev))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i], dev))
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes, in_units=channels[-1], device=dev)

    @staticmethod
    def _make_layer(block, layers, channels, stride, stage_index,
                    in_channels, device):
        layer = HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, device=device,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                device=device, prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, **kwargs):
    """ResNet ``v{version}`` with ``num_layers`` layers; ``kwargs`` go to
    :class:`ResNetV1` (``classes``, ``device`` or ``ctx``, ``prefix``).
    Only v1 is ported, without pretrained weights."""
    if kwargs.pop("pretrained", False):
        raise MXNetError("pretrained weights are not ported")
    if version != 1:
        raise MXNetError(f"ResNet v{version} is not ported; v1 is")
    if num_layers not in resnet_spec:
        raise MXNetError(f"no ResNet with {num_layers} layers; "
                         f"{sorted(resnet_spec)}")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
