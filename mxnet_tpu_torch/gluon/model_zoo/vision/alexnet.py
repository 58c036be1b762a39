"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``):
the same layers in the same name scopes, so ``collect_params()`` names
agree (``alexnet0_conv0_weight``).  The first ``Dense`` infers its width
from the input at the first forward (256·6·6 at 224 px)."""
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D
from ._base import ZooBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(ZooBlock):
    def __init__(self, classes=1000, device=None, ctx=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(Conv2D(64, kernel_size=11, strides=4,
                                         padding=2, activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(192, kernel_size=5, padding=2,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(384, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Flatten())
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
            self.output = Dense(classes)
        self._defer_to(device, ctx)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(ctx=ctx, **kwargs)
    if pretrained:
        from . import load_pretrained
        load_pretrained(net, "alexnet", root=root, ctx=ctx)
    return net
