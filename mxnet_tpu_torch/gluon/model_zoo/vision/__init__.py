"""Vision models of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/``): ResNet v1 and v2, AlexNet, VGG,
MobileNet v1 and v2, SqueezeNet, DenseNet and Inception v3, and
:func:`get_model`, which takes either spelling of a name
(``mobilenetv2_1.0`` or ``mobilenet_v2_1_0``) and, with
``pretrained=True``, loads the model's weights from the local
sha1-checked store (:mod:`..model_store`; no network)."""
import importlib
import inspect


def load_pretrained(net, name, root=None, ctx=None):
    """Load the verified weights of ``name`` from the local store under
    ``root`` into ``net`` (on ``ctx``)."""
    from ..model_store import get_model_file
    net.load_parameters(get_model_file(name, root=root), ctx=ctx)
    return net


from .resnet import *  # noqa: F401,F403,E402
from .alexnet import *  # noqa: F401,F403,E402
from .vgg import *  # noqa: F401,F403,E402
from .mobilenet import *  # noqa: F401,F403,E402
from .squeezenet import *  # noqa: F401,F403,E402
from .densenet import *  # noqa: F401,F403,E402
from .inception import *  # noqa: F401,F403,E402

_FAMILIES = ("resnet", "alexnet", "vgg", "mobilenet", "squeezenet",
             "densenet", "inception")
_models = {}
for _modname in _FAMILIES:
    _mod = importlib.import_module("." + _modname, __name__)
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower():
            _models[_name] = _obj

# the reference's spellings (dots for the width multipliers, no underscore
# in 'inceptionv3' / 'mobilenetv2') for the factory names
_REF_ALIASES = {
    "inceptionv3": "inception_v3",
    "squeezenet1.0": "squeezenet1_0",
    "squeezenet1.1": "squeezenet1_1",
    "mobilenet1.0": "mobilenet1_0",
    "mobilenet0.75": "mobilenet0_75",
    "mobilenet0.5": "mobilenet0_5",
    "mobilenet0.25": "mobilenet0_25",
    "mobilenetv2_1.0": "mobilenet_v2_1_0",
    "mobilenetv2_0.75": "mobilenet_v2_0_75",
    "mobilenetv2_0.5": "mobilenet_v2_0_5",
    "mobilenetv2_0.25": "mobilenet_v2_0_25",
}


def get_model(name, pretrained=False, root=None, ctx=None, **kwargs):
    """Build the zoo model ``name`` (either spelling); ``kwargs`` go to its
    factory (``classes``, ``prefix``, ``device``...).  ``pretrained=True``
    loads its weights from the local store under ``root`` on ``ctx``."""
    name = _REF_ALIASES.get(name.lower(), name.lower())
    if name not in _models:
        raise ValueError(f"model {name} not found; available: "
                         f"{sorted(_models)}")
    fn = _models[name]
    if "pretrained" in inspect.signature(fn).parameters:
        return fn(pretrained=pretrained, root=root, ctx=ctx, **kwargs)
    net = fn(ctx=ctx, **kwargs)
    if pretrained:
        load_pretrained(net, name, root=root, ctx=ctx)
    return net


__all__ = sorted(_models) + ["get_model", "load_pretrained", "ResNetV1",
                             "ResNetV2", "BasicBlockV1", "BasicBlockV2",
                             "BottleneckV1", "BottleneckV2", "AlexNet",
                             "VGG", "MobileNet", "MobileNetV2", "SqueezeNet",
                             "DenseNet", "Inception3"]
