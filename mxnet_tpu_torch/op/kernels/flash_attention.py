"""Flash attention forward: the hand-written CUDA kernel and its plain version.

``flash_attention_fwd`` is the port of the Pallas TPU kernel
``mxnet_tpu/op/pallas/flash_attention.py:_fwd_kernel`` (launched by
``_fwd_impl``, wrapped by ``flash_attention``).  Its kernel is
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``, built by ``nvcc`` at
first use.  ``attention_reference`` is the plain PyTorch version of the
same function: the port's copy of
``mxnet_tpu/parallel/ring_attention.py:attention_reference``, extended
to return the per-row logsumexp.

Layout: q ``[b, t_q, h, d]``, k and v ``[b, t_kv, h, d]``; both return
``(o, lse)`` with ``o`` ``[b, t_q, h, d]`` in q's dtype and ``lse``
``[b*h, t_q]`` in float32 (the JAX kernel's convention: ``-inf`` for a
fully masked row, whose ``o`` is 0).  The causal mask is top-left
aligned: query ``i`` sees keys ``j <= i`` whatever ``t_q`` and ``t_kv``.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .build import CudaLibrary

__all__ = ["flash_attention_fwd", "attention_reference", "LIBRARY"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_BLOCK_M = 64            # query rows per block in the kernel
_MAX_Q_TILES = 65535     # the kernel's grid limit on query tiles


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain O(T^2) attention in float32; returns ``(o, lse)``."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.arange(t_q, device=q.device)[:, None] \
            >= torch.arange(t_kv, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    # a fully masked row's softmax is nan: its output is 0 instead
    p = torch.softmax(s, dim=-1).masked_fill(
        torch.isneginf(lse)[..., None], 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse.reshape(b * h, t_q)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash attention takes [b, t, h, d] q, k and v; got "
                         "%s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise MXNetError("flash attention: k %s and v %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if not q.device == k.device == v.device:
        raise MXNetError("flash attention: q, k, v on different devices")


def _check_kernel_args(q, k, v):
    """What the CUDA kernel takes beyond what the plain version does."""
    if q.dtype not in _KERNEL_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise MXNetError("flash attention kernel takes float32 or bfloat16 "
                         "q, k, v of one dtype; got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise MXNetError("flash attention kernel takes 1 <= head_dim <= %d;"
                         " got %d" % (MAX_HEAD_DIM, q.shape[-1]))
    if -(-q.shape[1] // _BLOCK_M) > _MAX_Q_TILES:
        raise MXNetError("flash attention kernel takes t_q <= %d; got %d"
                         % (_MAX_Q_TILES * _BLOCK_M, q.shape[1]))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise MXNetError("flash attention kernel needs %s's last "
                             "dimension contiguous; got strides %s"
                             % (name, x.stride()))


def _declare(lib):
    fn = lib.mxtt_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention_fwd", _declare)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Exact attention forward; returns ``(o, lse)``.

    CUDA tensors run the hand-written kernel, or raise: there is no
    fallback.  CPU tensors run the plain version; meta tensors (shape
    inference) get empty outputs of the right shape.
    """
    _check_shapes(q, k, v)
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise MXNetError("flash attention runs on cuda or cpu tensors; got %s"
                         % q.device)
    o = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    if q.device.type == "meta" or lse.numel() == 0:
        return o, lse
    _check_kernel_args(q, k, v)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, t_q, t_kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError("flash attention kernel launch failed: %s (CUDA "
                         "error %d)"
                         % (lib.mxtt_cuda_error_string(err).decode(), err))
    flash_attention_fwd.launches += 1
    return o, lse


# kernel launches since the count was last set to 0 (the plain version
# and meta inference never count)
flash_attention_fwd.launches = 0
