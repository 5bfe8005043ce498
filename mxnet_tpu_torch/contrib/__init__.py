"""Python-level contrib namespace (``mxnet_tpu/contrib``); the op
namespaces live on ``mx.sym.contrib`` / ``mx.nd.contrib``."""
from . import quantization  # noqa: F401
