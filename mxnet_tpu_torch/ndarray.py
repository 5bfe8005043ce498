"""Imperative NDArray over ``torch.Tensor`` (``mxnet_tpu/ndarray.py``).

The reference NDArray (``include/mxnet/ndarray.h:58-445``) pairs every
array with an engine variable; here an NDArray holds one tensor, and
torch's stream ordering gives the same read/write order per buffer.

* Views (``a[i]``, ``a[i:j]``, ``a.reshape(...)``) are torch views of the
  same memory, so a write through a view reaches its base, as in the
  reference (``ndarray.h:284-310``).  The JAX package gets the same by
  re-deriving views from their base.
* Mutation (``+=``, ``a[:] = v``, ``out=``) writes into the tensor in
  place; the shape never changes under it.
* ``wait_to_read`` syncs the tensor's stream; ``waitall`` every CUDA
  device.
* ``asnumpy()`` of a bfloat16 array returns float32 values (numpy has no
  bfloat16; the widening is exact), where the JAX package returns its
  ``ml_dtypes`` bfloat16 array.

An array made without a context lands on :func:`current_context`, which
is ``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise: on a
machine without CUDA that raises instead of falling back.

Save/load use the reference binary format (``src/ndarray/ndarray.cc:
623-706``), so ``.params`` files are shared with the JAX package and the
reference.  Loads land on the CPU; ``as_in_context`` moves them.
"""
from __future__ import annotations

import io
import math
import struct
from numbers import Number

import numpy as np
import torch

from .base import (Context, MXNetError, _DTYPE_MX_TO_TORCH, cast,
                   _DTYPE_TORCH_TO_MX, _dtype, current_context)
from .op import registry as _reg
from .op.tensor import one_hot as _one_hot

__all__ = ["NDArray", "empty", "zeros", "ones", "full", "array", "arange",
           "concatenate", "save", "load", "load_buffer", "waitall",
           "onehot_encode", "moveaxis", "transpose"]


def waitall():
    """Block until the work queued on every CUDA device finishes
    (reference ``ndarray.py:95``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device == b.device and \
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class NDArray:
    """N-dimensional array on a device (the host or a CUDA card)."""

    # ``grad`` is the gradient array of a variable marked for autograd
    # (``attach_grad``), ``_grad_req`` its request
    __slots__ = ("_data", "_writable", "grad", "_grad_req", "__weakref__")
    # make numpy defer binary ops to us (np_arr * nd_arr is an NDArray)
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor, writable=True):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(data).__name__)
        self._data = data
        self._writable = writable
        self.grad = None
        self._grad_req = None

    # ------------------------------------------------------------------
    # raw value plumbing
    @property
    def data(self) -> torch.Tensor:
        """The tensor this array holds (a view's shares its base's
        memory)."""
        return self._data

    def _set_data(self, value):
        """Write ``value`` into this array's memory, in place, casting to
        its dtype and moving it to its device."""
        if not self._writable:
            raise MXNetError("trying to write to a read-only NDArray")
        value = torch.as_tensor(value)
        if tuple(value.shape) != self.shape:
            raise MXNetError("cannot write a value of shape %s into an "
                             "NDArray of shape %s"
                             % (tuple(value.shape), self.shape))
        if _shares_memory(value, self._data):
            value = value.clone()
        with torch.no_grad():   # a write is never differentiated
            self._data.copy_(value)

    # ------------------------------------------------------------------
    # properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def context(self) -> Context:
        return Context.from_torch_device(self._data.device)

    ctx = context

    @property
    def T(self):
        return transpose(self)

    @property
    def handle(self):
        return self  # FFI-compat shim: the NDArray is its own handle

    # ------------------------------------------------------------------
    # conversion
    def asnumpy(self) -> np.ndarray:
        """A host copy; bfloat16 comes back as float32 (exact)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.shape != (1,) and self.shape != ():
            raise MXNetError("the current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        dtype = _dtype(dtype)
        out = cast(self._data, dtype)
        return NDArray(out.clone() if out is self._data else out)

    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into another NDArray or to a Context (reference
        ``ndarray.py:780``)."""
        if isinstance(other, NDArray):
            if other is not self:
                other._set_data(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    def reshape(self, *shape):
        """A view of the same memory in another shape (``-1`` infers one
        dimension)."""
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        try:
            view = self._data.view(shape)
        except RuntimeError as e:
            raise MXNetError("cannot view an NDArray of shape %s as %s: %s"
                             % (self.shape, shape, e)) from None
        return NDArray(view, writable=self._writable)

    def broadcast_to(self, shape):
        return NDArray(self._data.expand(tuple(shape)).clone())

    # ------------------------------------------------------------------
    # sync
    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # ------------------------------------------------------------------
    # indexing
    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return NDArray(self._data[int(key)], writable=self._writable)
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise MXNetError("slice step is not supported")
            return NDArray(self._data[key], writable=self._writable)
        raise MXNetError("NDArray only supports int and slice indexing")

    def __setitem__(self, key, value):
        if not isinstance(key, (int, np.integer, slice)):
            raise MXNetError("unsupported key type for __setitem__")
        target = self[key]
        if isinstance(value, NDArray):
            value = value.data
        elif isinstance(value, Number):
            value = torch.as_tensor(value, dtype=self.dtype)
        elif not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        try:
            value = value.to(target.data.device).expand(target.shape)
        except RuntimeError as e:
            raise MXNetError("cannot assign a value of shape %s to shape "
                             "%s: %s" % (tuple(value.shape), target.shape,
                                         e)) from None
        target._set_data(value)

    def _sync_copyfrom(self, source_array):
        src = np.ascontiguousarray(source_array)
        if src.shape != self.shape:
            raise MXNetError("array shape do not match the shape of NDArray")
        self._set_data(torch.from_numpy(src))

    # ------------------------------------------------------------------
    # arithmetic, routed through the op registry
    def __add__(self, other):
        return _ufunc(self, other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __iadd__(self, other):
        self._set_data(_ufunc(self, other, "_plus", "_plus_scalar").data)
        return self

    def __sub__(self, other):
        return _ufunc(self, other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return _ufunc(self, other, None, "_rminus_scalar")

    def __isub__(self, other):
        self._set_data(_ufunc(self, other, "_minus", "_minus_scalar").data)
        return self

    def __mul__(self, other):
        return _ufunc(self, other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __imul__(self, other):
        self._set_data(_ufunc(self, other, "_mul", "_mul_scalar").data)
        return self

    def __neg__(self):
        return _ufunc(self, -1.0, "_mul", "_mul_scalar")

    def __truediv__(self, other):
        return _ufunc(self, other, "_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, other):
        return _ufunc(self, other, None, "_rdiv_scalar")

    __rdiv__ = __rtruediv__

    def __itruediv__(self, other):
        self._set_data(_ufunc(self, other, "_div", "_div_scalar").data)
        return self

    def __mod__(self, other):
        return _ufunc(self, other, "_mod", "_mod_scalar")

    def __pow__(self, other):
        return _ufunc(self, other, "_power", "_power_scalar")

    def __eq__(self, other):
        return _ufunc(self, other, "_equal", "_equal_scalar")

    def __ne__(self, other):
        return _ufunc(self, other, "_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return _ufunc(self, other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return _ufunc(self, other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return _ufunc(self, other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _ufunc(self, other, "_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise MXNetError(
            "The truth value of an NDArray is ambiguous; use asscalar()")

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # ------------------------------------------------------------------
    # pickling (optimizer states in a checkpoint): the values on the host
    def __getstate__(self):
        return {"data": self._data.detach().cpu(), "writable": self._writable}

    def __setstate__(self, state):
        self._data = state["data"]
        self._writable = state["writable"]
        self.grad = None
        self._grad_req = None

    def attach_grad(self, grad_req="write"):
        """Mark this array for autograd with a zero gradient array
        (``self.grad``)."""
        from . import autograd
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data))], [grad_req])

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into the marked variables'."""
        from . import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)


def _ufunc(lhs, rhs, array_op, scalar_op):
    """Binary op dispatch: NDArray/NDArray vs NDArray/scalar
    (reference ``ndarray.py:1151`` _ufunc_helper)."""
    from .op.invoke import invoke
    if isinstance(rhs, NDArray):
        if array_op is None:
            raise MXNetError("operation not supported between two NDArrays")
        return invoke(_reg.get(array_op), [lhs, rhs], {})[0]
    if isinstance(rhs, Number):
        return invoke(_reg.get(scalar_op), [lhs], {"scalar": float(rhs)})[0]
    raise TypeError("type %s not supported" % str(type(rhs)))


# ----------------------------------------------------------------------
# creation functions (reference ndarray.py:888-1151)
def _device(ctx) -> torch.device:
    return (current_context() if ctx is None else Context.parse(ctx)) \
        .torch_device()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(_shape(shape), dtype=_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype(dtype),
                              device=_device(ctx)))


# numpy's 64-bit defaults become the JAX package's 32-bit ones
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def array(source_array, ctx=None, dtype=None):
    """An array holding a copy of ``source_array`` (an NDArray, a tensor
    or anything numpy reads).  Without ``dtype`` the source's dtype is
    kept, float64 and int64 narrowed to 32 bits as the JAX package's
    arrays are."""
    if isinstance(source_array, NDArray):
        src = source_array.data
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        src = torch.from_numpy(np.ascontiguousarray(source_array))
    dt = _NARROW.get(src.dtype, src.dtype) if dtype is None \
        else _dtype(dtype)
    src = src.to(device=_device(ctx), dtype=dt, copy=True)
    return NDArray(src.reshape((1,)) if src.dim() == 0 else src)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    from .op.invoke import invoke
    kwargs = dict(start=start, stop=stop, step=step, repeat=repeat,
                  ctx=None if ctx is None else str(ctx))
    if dtype is not None:
        kwargs["dtype"] = dtype
    return invoke(_reg.get("_arange"), [], kwargs)[0]


def concatenate(arrays, axis=0, always_copy=True):
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return NDArray(torch.cat([a.data for a in arrays], dim=axis))


def moveaxis(tensor, source, destination):
    return NDArray(torch.movedim(tensor.data, source, destination).clone())


def transpose(arr, axes=None):
    from .op.invoke import invoke
    return invoke(_reg.get("transpose"), [arr], {"axes": axes})[0]


def onehot_encode(indices, out):
    """One-hot encode into ``out`` (reference ``ndarray.py:877``)."""
    out._set_data(_one_hot(indices.data, out.shape[1], out.dtype))
    return out


# ----------------------------------------------------------------------
# binary serialization: the reference's on-disk format
_MAGIC = 0x112
# the reference's device type ids: an array saved from the card is tagged
# gpu (2) so files round-trip; loads always land on the CPU
_DEVTYPE = {"cpu": 1, "cuda": 2}
# same-width integer twins: tensor bytes move through numpy, which has no
# bfloat16
_BYTES_AS = {torch.bfloat16: torch.int16}


def _save_one(f, arr):
    if isinstance(arr, NDArray):
        arr = arr.data
    shape = tuple(arr.shape)
    f.write(struct.pack("<I", len(shape)))
    if not shape:
        # ndim==0 is the reference's "none" array: shape only, no payload
        return
    f.write(struct.pack("<%dI" % len(shape), *shape))
    f.write(struct.pack("<ii", _DEVTYPE.get(arr.device.type, 2),
                        arr.device.index or 0))
    if arr.dtype not in _DTYPE_TORCH_TO_MX:
        arr = arr.float()
    f.write(struct.pack("<i", _DTYPE_TORCH_TO_MX[arr.dtype]))
    host = arr.detach().to("cpu").contiguous()
    host = host.view(_BYTES_AS.get(host.dtype, host.dtype))
    f.write(host.numpy().tobytes())


def _load_one(f) -> NDArray:
    ndim, = struct.unpack("<I", f.read(4))
    if ndim == 0:
        return NDArray(torch.zeros(()))
    shape = struct.unpack("<%dI" % ndim, f.read(4 * ndim))
    _devtype, _devid = struct.unpack("<ii", f.read(8))
    type_flag, = struct.unpack("<i", f.read(4))
    if type_flag not in _DTYPE_MX_TO_TORCH:
        raise MXNetError("unknown dtype flag %d in NDArray file" % type_flag)
    dt = _DTYPE_MX_TO_TORCH[type_flag]
    twin = _BYTES_AS.get(dt, dt)
    nbytes = math.prod(shape) * twin.itemsize
    buf = f.read(nbytes)
    if len(buf) != nbytes:
        raise MXNetError("NDArray file truncated: %d of %d payload bytes"
                         % (len(buf), nbytes))
    flat = torch.frombuffer(bytearray(buf), dtype=twin) if nbytes \
        else torch.empty(0, dtype=twin)
    return NDArray(flat.view(dt).reshape(shape))


def save(fname, data):
    """Save NDArrays or tensors in the reference binary format
    (``src/ndarray/ndarray.cc:680-691``): one array, a list, or a dict of
    name -> array (a checkpoint names them ``arg:<name>`` and
    ``aux:<name>``)."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data, names = [data], []
    elif isinstance(data, dict):
        names = list(data.keys())
        data = list(data.values())
    elif isinstance(data, (list, tuple)):
        names = []
    else:
        raise TypeError("save expects dict/list/NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _MAGIC, 0))
        f.write(struct.pack("<Q", len(data)))
        for arr in data:
            _save_one(f, arr)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname):
    """Load NDArrays (on the CPU) saved by :func:`save`, the JAX package
    or the reference: a dict when the file names them, else a list."""
    with open(fname, "rb") as f:
        return _load_fileobj(f)


def load_buffer(blob: bytes):
    """:func:`load` from an in-memory blob (the C predict API's
    load-from-bytes path, reference ``c_predict_api.cc:87-117``)."""
    return _load_fileobj(io.BytesIO(blob))


def _load_fileobj(f):
    magic, _ = struct.unpack("<QQ", f.read(16))
    if magic != _MAGIC:
        raise MXNetError("Invalid NDArray file format")
    n, = struct.unpack("<Q", f.read(8))
    data = [_load_one(f) for _ in range(n)]
    k, = struct.unpack("<Q", f.read(8))
    names = []
    for _ in range(k):
        ln, = struct.unpack("<Q", f.read(8))
        names.append(f.read(ln).decode("utf-8"))
    if names:
        return dict(zip(names, data))
    return data


_FRONT_ENDS = {}


def __getattr__(name):
    """Every registered op resolves to its generated ``mx.nd.<op>``
    front-end (PEP 562), late registrations included."""
    fn = _FRONT_ENDS.get(name)
    if fn is None:
        try:
            op = _reg.get(name)
        except MXNetError:
            raise AttributeError("module %r has no attribute %r"
                                 % (__name__, name)) from None
        from .op.invoke import make_ndarray_function
        fn = _FRONT_ENDS[name] = make_ndarray_function(op)
    return fn
