"""Operator library: importing this package populates the registry."""
from . import registry
from .registry import OpContext, Op, Param, register, alias, get

from . import elemwise  # noqa: F401
from . import tensor  # noqa: F401
from . import init_ops  # noqa: F401
from . import nn  # noqa: F401
from . import attention  # noqa: F401
from . import rnn_op  # noqa: F401
from . import optimizer_op  # noqa: F401
from . import vision  # noqa: F401
from . import contrib  # noqa: F401
from . import ctc  # noqa: F401
