"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``): ``BasicBlockV1``,
``BottleneckV1``, ``ResNetV1``, ``BasicBlockV2``, ``BottleneckV2``,
``ResNetV2``, ``resnet{18,34,50,101,152}_v1`` and ``_v2``.

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
``broadcast_add`` and ``Activation``), which ``export`` traces.  v2 is
pre-activation: each block normalises and activates its input first (its
downsample reads that), and the net starts with a BatchNorm whose gamma
and beta stay out of the gradient (``scale=False, center=False``) and
ends with BN + ReLU before the pool.  ``thumbnail`` replaces the 7x7/2
stem (and v1's max pool) with a 3x3/1 conv for 32 px images.
``pretrained=True`` loads ``resnet{n}_v{v}`` from the local store
(``model_store``), built unfused whatever ``MXNET_TPU_FUSE_CONV_BN`` says
(the fused blocks name their parameters differently), as the JAX package
does.
"""
from __future__ import annotations

import warnings

import torch

from ....base import MXNetError, env
from ....context import resolve_device
from ...block import HybridBlock
from ...contrib.nn import FusedConv1x1BN
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]

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


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self.bn1 = BatchNorm(in_channels=in_channels, device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, device)
        self.bn2 = BatchNorm(in_channels=channels, device=device)
        self.conv2 = _conv3x3(channels, 1, channels, device)
        self.downsample = (Conv2D(channels, 1, stride, use_bias=False,
                                  in_channels=in_channels, device=device)
                           if downsample else None)

    def _convs(self):
        return [(self.bn2, self.conv2)]

    def forward(self, x):
        return _pre_activation(torch.relu, self, x)

    def hybrid_forward(self, F, x):
        return _pre_activation(
            lambda t: F.Activation(t, act_type="relu"), self, x)


def _pre_activation(relu, block, x):
    """A v2 block: ``relu(bn1(x))`` feeds the downsample (when there is
    one) and ``conv1``; each later (bn, conv) pair of ``block._convs()``
    follows as ``conv(relu(bn(out)))``; the residual adds last."""
    out = relu(block.bn1(x))
    residual = x if block.downsample is None else block.downsample(out)
    out = block.conv1(out)
    for bn, conv in block._convs():
        out = conv(relu(bn(out)))
    return out + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        mid = channels // 4
        self.bn1 = BatchNorm(in_channels=in_channels, device=device)
        self.conv1 = Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                            in_channels=in_channels, device=device)
        self.bn2 = BatchNorm(in_channels=mid, device=device)
        self.conv2 = _conv3x3(mid, stride, mid, device)
        self.bn3 = BatchNorm(in_channels=mid, device=device)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, in_channels=mid, device=device)
        self.downsample = (Conv2D(channels, 1, stride, use_bias=False,
                                  in_channels=in_channels, device=device)
                           if downsample else None)

    def _convs(self):
        return [(self.bn2, self.conv2), (self.bn3, self.conv3)]

    forward = BasicBlockV2.forward
    hybrid_forward = BasicBlockV2.hybrid_forward


def _device_of(device, ctx):
    if device is None and ctx is not None:
        device = ctx.torch_device()
    return resolve_device(device)


def _stem(features, channels, thumbnail, dev, max_pool=True):
    """The 7x7/2 conv, BN, ReLU (and 3x3/2 max pool), or with
    ``thumbnail`` one 3x3/1 conv."""
    if thumbnail:
        features.add(_conv3x3(channels, 1, _IMAGE_CHANNELS, dev))
        return
    features.add(Conv2D(channels, 7, 2, 3, use_bias=False,
                        in_channels=_IMAGE_CHANNELS, device=dev))
    features.add(BatchNorm(in_channels=channels, device=dev))
    features.add(Activation("relu"))
    if max_pool:
        features.add(MaxPool2D(3, 2, 1))


def _check_stages(name, layers, channels):
    if len(layers) != len(channels) - 1:
        raise MXNetError(f"{name}: {len(layers)} stages need "
                         f"{len(layers) + 1} channel counts, got {channels}")


class ResNetV1(HybridBlock):
    """ResNet v1: a 7x7/2 conv, BN, ReLU and 3x3/2 max pool (or the
    thumbnail's 3x3 conv), then ``len(layers)`` stages of ``block`` (stride
    2 from the second), global average pooling and a ``Dense`` head.
    Built on ``device`` (or ``ctx``; default ``cuda``, raising without
    CUDA) with the tensors allocated: fill them with ``initialize()`` (or
    :func:`~mxnet_tpu_torch.initializer.initialize`) or load them."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None, ctx=None, **kwargs):
        _check_stages("ResNetV1", layers, channels)
        dev = _device_of(device, ctx)
        super().__init__(device=dev, **kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _stem(self.features, channels[0], thumbnail, dev)
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


class ResNetV2(HybridBlock):
    """ResNet v2: a BatchNorm without gamma or beta on the image, the v1
    stem, ``len(layers)`` stages of pre-activation ``block`` s, BN + ReLU,
    global average pooling, ``Flatten`` and a ``Dense`` head.  Built on
    ``device`` as :class:`ResNetV1` is."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None, ctx=None, **kwargs):
        _check_stages("ResNetV2", layers, channels)
        dev = _device_of(device, ctx)
        super().__init__(device=dev, **kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(BatchNorm(scale=False, center=False,
                                        in_channels=_IMAGE_CHANNELS,
                                        device=dev))
            _stem(self.features, channels[0], thumbnail, dev)
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(ResNetV1._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels, dev))
                in_channels = channels[i + 1]
            self.features.add(BatchNorm(in_channels=in_channels, device=dev))
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes, in_units=in_channels, device=dev)

    forward = ResNetV1.forward
    hybrid_forward = ResNetV1.hybrid_forward


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                             "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, root=None, **kwargs):
    """ResNet ``v{version}`` with ``num_layers`` layers; ``kwargs`` go to
    :class:`ResNetV1` / :class:`ResNetV2` (``classes``, ``thumbnail``,
    ``device`` or ``ctx``, ``prefix``).  ``pretrained`` loads
    ``resnet{num_layers}_v{version}`` from the local store under ``root``
    (see the module docstring)."""
    if pretrained and env.MXNET_TPU_FUSE_CONV_BN:
        warnings.warn(
            "MXNET_TPU_FUSE_CONV_BN=1 is ignored for pretrained=True: the "
            "fused blocks use a different parameter namespace than saved "
            "checkpoints. Build without pretrained to train fused.",
            UserWarning, stacklevel=2)
        saved = env.MXNET_TPU_FUSE_CONV_BN
        env.MXNET_TPU_FUSE_CONV_BN = 0
        try:
            return get_resnet(version, num_layers, pretrained, root,
                              **kwargs)
        finally:
            env.MXNET_TPU_FUSE_CONV_BN = saved
    if version not in _VERSIONS:
        raise MXNetError(f"no ResNet v{version}; v1 and v2")
    if num_layers not in resnet_spec:
        raise MXNetError(f"no ResNet with {num_layers} layers; "
                         f"{sorted(resnet_spec)}")
    block_type, layers, channels = resnet_spec[num_layers]
    net_class, blocks = _VERSIONS[version]
    net = net_class(blocks[block_type], layers, channels, **kwargs)
    if pretrained:
        from . import load_pretrained
        load_pretrained(net, f"resnet{num_layers}_v{version}", root=root,
                        ctx=kwargs.get("ctx"))
    return net


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


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
