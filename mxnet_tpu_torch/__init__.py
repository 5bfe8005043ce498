"""PyTorch/CUDA port of ``mxnet_tpu``: the same names and module layout,
torch tensors inside, hand-written Hopper kernels where the JAX package
has Pallas kernels.  It imports neither JAX nor ``mxnet_tpu``.

This slice serves the transformer LM through :class:`Predictor`.
"""
from . import base
from .base import Context, MXNetError, cpu, gpu
from . import name
from . import attribute
from .attribute import AttrScope
from . import op
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from .symbol import Variable
from . import executor
from . import serving
from . import predictor
from .predictor import Predictor
from . import models
from . import convert
