"""The fused train step (``mxnet_tpu/parallel``), on one device: the
:class:`Trainer` and the optimizer update it applies.  Meshes,
collectives and the large-model parallel layers wait for later slices of
the port."""
from .optim import make_update_fn
from .trainer import Trainer

__all__ = ["Trainer", "make_update_fn"]
