"""Model zoo: Symbol builders (``mxnet_tpu/models``) for the networks
the port runs: the MLP, LeNet, ResNet, the transformer LM and the
bucketing LSTM LM.

Use :func:`get_symbol`::

    sym = mt.models.get_symbol("resnet-50", num_classes=1000,
                               layout="NHWC")
"""
from . import lenet
from . import lstm_lm
from . import mlp
from . import resnet
from . import transformer

__all__ = ["get_symbol", "lenet", "lstm_lm", "mlp", "resnet", "transformer"]

_BUILDERS = {
    "mlp": mlp.get_symbol,
    "lenet": lenet.get_symbol,
    "lstm_lm": lstm_lm.get_symbol,
    "transformer": transformer.get_symbol,
    "gpt": transformer.get_symbol,
}

# the JAX package's other networks, which the port builds in a later slice
_LATER = ("alexnet", "vgg", "googlenet", "inception-bn", "inception-v3",
          "inception-resnet-v2", "resnext")


def get_symbol(network, num_classes=1000, **kwargs):
    """Build a named network Symbol.

    ``network`` is a plain name (``"lenet"``) or a name-depth form
    (``"resnet-50"``), as the reference's ``--network`` strings."""
    if network in _BUILDERS:
        return _BUILDERS[network](num_classes=num_classes, **kwargs)
    if network.startswith("resnet") and not network.startswith("resnext"):
        depth = int(network.split("-")[1]) if "-" in network else \
            int(kwargs.pop("num_layers", 50))
        return resnet.get_symbol(num_classes=num_classes, num_layers=depth,
                                 **kwargs)
    if any(network == n or network.startswith(n + "-") for n in _LATER):
        raise ValueError("network %r is not ported yet: the zoo's other "
                         "networks come with a later slice of the port"
                         % (network,))
    raise ValueError("unknown network %r (have %s, resnet-N)"
                     % (network, sorted(_BUILDERS)))
