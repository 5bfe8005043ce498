"""Model zoo: Symbol builders (``mxnet_tpu/models``) for the reference's
example networks (``example/image-classification/symbols/``: mlp, lenet,
alexnet, vgg, resnet, resnext, googlenet, inception-bn, inception-v3,
inception-resnet-v2), the bucketing LSTM LM and the transformer LM.

Use :func:`get_symbol`::

    sym = mt.models.get_symbol("resnet-50", num_classes=1000,
                               layout="NHWC")
"""
from . import alexnet
from . import googlenet
from . import inception_bn
from . import inception_resnet_v2
from . import inception_v3
from . import lenet
from . import lstm_lm
from . import mlp
from . import resnet
from . import resnext
from . import transformer
from . import vgg

__all__ = ["get_symbol", "alexnet", "googlenet", "inception_bn",
           "inception_resnet_v2", "inception_v3", "lenet", "lstm_lm", "mlp",
           "resnet", "resnext", "transformer", "vgg"]

_BUILDERS = {
    "mlp": mlp.get_symbol,
    "lenet": lenet.get_symbol,
    "alexnet": alexnet.get_symbol,
    "googlenet": googlenet.get_symbol,
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception-resnet-v2": inception_resnet_v2.get_symbol,
    "lstm_lm": lstm_lm.get_symbol,
    "transformer": transformer.get_symbol,
    "gpt": transformer.get_symbol,
}

# name-depth families: ("resnet-50", "resnext-101", "vgg-16"), each with
# the depth it builds when the name has none
_DEPTHS = (("resnext", resnext.get_symbol, 50),
           ("resnet", resnet.get_symbol, 50),
           ("vgg", vgg.get_symbol, 16))


def get_symbol(network, num_classes=1000, **kwargs):
    """Build a named network Symbol.

    ``network`` is a plain name (``"alexnet"``) or a name-depth form
    (``"resnet-50"``, ``"vgg-16"``), as the reference's ``--network``
    strings."""
    if network in _BUILDERS:
        return _BUILDERS[network](num_classes=num_classes, **kwargs)
    for family, build, default in _DEPTHS:
        if network.startswith(family):
            depth = int(network.split("-")[1]) if "-" in network else \
                int(kwargs.pop("num_layers", default))
            return build(num_classes=num_classes, num_layers=depth,
                         **kwargs)
    raise ValueError("unknown network %r (have %s, resnet-N, resnext-N, "
                     "vgg-N)" % (network, sorted(_BUILDERS)))
