"""The reference binary format for tensors (``mxnet_tpu/ndarray.py:464-545``,
reference ``src/ndarray/ndarray.cc:680-691``), over torch tensors.

A ``.params`` file written by the JAX package (or by the reference)
loads here, and one written here loads there.  Tensors load onto the CPU;
the caller moves them.
"""
from __future__ import annotations

import io
import math
import struct
from typing import Dict

import torch

from .base import MXNetError, _DTYPE_MX_TO_TORCH, _DTYPE_TORCH_TO_MX

__all__ = ["save", "load", "load_buffer"]

_MAGIC = 0x112
# the reference's device type ids: a tensor saved from the card is tagged
# gpu (2) so files round-trip; loads always land on the CPU
_DEVTYPE = {"cpu": 1, "cuda": 2}
# same-width integer twins: tensor bytes move through numpy, which has no
# bfloat16
_BYTES_AS = {torch.bfloat16: torch.int16}


def _save_one(f, arr: torch.Tensor):
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


def _load_one(f) -> torch.Tensor:
    ndim, = struct.unpack("<I", f.read(4))
    if ndim == 0:
        return torch.zeros(())
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
    return flat.view(dt).reshape(shape)


def save(fname, data: Dict[str, torch.Tensor]):
    """Save named tensors in the reference binary format (a checkpoint
    names them ``arg:<name>`` and ``aux:<name>``)."""
    if not isinstance(data, dict):
        raise TypeError("save expects a dict of name -> tensor")
    names = list(data.keys())
    data = list(data.values())
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
    """Load tensors saved by :func:`save`, the JAX package or the
    reference: a dict when the file names them, else a list."""
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
