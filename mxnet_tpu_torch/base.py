"""Core types: Context (device model), dtype flags, errors.

The PyTorch counterpart of ``mxnet_tpu/base.py``.  A Context resolves to a
``torch.device``: ``gpu(i)`` is CUDA device ``i``, ``cpu()`` the host.
Nothing falls back: a ``gpu`` Context on a machine without that CUDA
device raises instead of quietly running on the CPU.  The default context
is ``gpu(0)`` (the JAX package's falls back to the CPU); code that means
the CPU says so with ``with mx.cpu():`` or ``ctx=mx.cpu()``.
"""
from __future__ import annotations

import re
import threading

import numpy as np
import torch

__all__ = ["MXNetError", "Context", "cpu", "gpu", "default_context",
           "set_default_context", "current_context",
           "_DTYPE_TORCH_TO_MX", "_DTYPE_MX_TO_TORCH", "_dtype", "dtype_name",
           "cast"]


class MXNetError(RuntimeError):
    """Framework error type (reference: dmlc error -> MXGetLastError)."""


# dtype <-> integer flag mapping of the reference binary format (mshadow's
# type flags; 7 is the bfloat16 extension flag the JAX package writes)
_DTYPE_TORCH_TO_MX = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.int8: 5,
    torch.int64: 6,
    torch.bfloat16: 7,
    torch.bool: 8,
}
_DTYPE_MX_TO_TORCH = {v: k for k, v in _DTYPE_TORCH_TO_MX.items()}

_DTYPE_BY_NAME = {str(dt).replace("torch.", ""): dt
                  for dt in _DTYPE_TORCH_TO_MX}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the spelling symbol JSON uses."""
    return str(dtype).replace("torch.", "")


def _dtype(dtype) -> torch.dtype:
    """Normalize a user dtype (torch dtype / numpy dtype / name / mx flag)
    to a ``torch.dtype``.  ``None`` is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, int) and not isinstance(dtype, bool):
        return _DTYPE_MX_TO_TORCH[dtype]
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPE_BY_NAME:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPE_BY_NAME[name]


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted to ``dtype`` as the JAX package's ``astype`` does:
    a float converted to an integer type truncates toward zero and
    saturates at the type's range, NaN giving 0 (``.to`` alone wraps, and
    its NaN is undefined).  Every other conversion is ``.to``'s."""
    if not x.is_floating_point() or dtype.is_floating_point \
            or dtype.is_complex or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # float64 holds every float exactly and the int32 bounds too; the
    # int64 top (2^63 - 1) rounds up to 2^63, so values that reach it are
    # set to the top after the conversion
    wide = torch.nan_to_num(x.double(), nan=0.0)
    out = wide.clamp(info.min, info.max).to(dtype)
    return torch.where(wide >= float(info.max), info.max, out)


class Context:
    """Device context: ``cpu(0)``, ``gpu(1)``...

    A (device type, device id) pair with string form ``"gpu(0)"``, as in
    the reference (``include/mxnet/base.h:116-207``).  The device type
    may be given by name or by the reference's integer id (1 = cpu,
    2 = gpu).
    """

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    # the context of the innermost ``with ctx:`` scope, per thread
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if isinstance(device_type, int) and not isinstance(device_type, bool):
            if device_type not in Context.devtype2str:
                raise MXNetError("unknown device type id %d" % device_type)
            device_type = Context.devtype2str[device_type]
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %r (expected one of %s)"
                             % (device_type, sorted(Context.devstr2type)))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def from_torch_device(cls, device: torch.device) -> "Context":
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    @classmethod
    def parse(cls, v) -> "Context":
        """A Context from itself or its string form ``"gpu(1)"`` (an op's
        ``ctx`` param)."""
        if isinstance(v, Context):
            return v
        m = re.fullmatch(r"\s*(\w+)\((\d+)\)\s*", str(v))
        if m is None:
            raise MXNetError("cannot read a context from %r" % (v,))
        return cls(m.group(1), int(m.group(2)))

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names; raises when it names
        a CUDA device this process cannot see."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but no CUDA device is available; ask for the "
                "CPU (mx.cpu(), dev_type='cpu') to run there" % self)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, n))
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    """Return a CPU context (reference ``base.h:240``)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return a CUDA context (reference ``base.h:252``)."""
    return Context("gpu", device_id)


# the card of this process: 0, or a worker's ``rank % device_count``
# (``parallel.collectives.join_from_env``)
_DEFAULT_GPU = 0


def set_default_gpu(device_id: int):
    """Make ``gpu(device_id)`` the default context of every thread."""
    global _DEFAULT_GPU
    _DEFAULT_GPU = int(device_id)


def default_context() -> Context:
    """The framework default, ``gpu(0)`` (a worker's own card, under the
    launcher), unless a ``with`` scope or :func:`set_default_context`
    chose another.  There is no fallback to the CPU: on a machine without
    CUDA, using it raises."""
    override = getattr(Context._default_ctx, "value", None)
    return override if override is not None else Context("gpu",
                                                         _DEFAULT_GPU)


def set_default_context(ctx: Context):
    """Set this thread's default context (reference
    ``test_utils.py:34`` set_default_context)."""
    Context._default_ctx.value = ctx


def current_context() -> Context:
    """The context of the innermost ``with mx.Context(...)`` scope."""
    return default_context()


Context.default_ctx = property(lambda self: current_context())
