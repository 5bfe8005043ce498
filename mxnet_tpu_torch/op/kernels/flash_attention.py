"""Flash attention: the hand-written CUDA kernels and their plain versions.

``flash_attention_fwd`` is the port of the Pallas TPU kernel
``mxnet_tpu/op/pallas/flash_attention.py:_fwd_kernel`` (launched by
``_fwd_impl``, wrapped by ``flash_attention``).  The input dtype picks its
kernel, each built by ``nvcc`` at first use:

- bfloat16: ``mxnet_tpu_torch/csrc/flash_attention_fwd_bf16.cu``, on the
  tensor cores (``wgmma``), fed by TMA through a ring of shared-memory
  stages by a producer warp;
- float32: ``mxnet_tpu_torch/csrc/flash_attention_fwd_f32.cu``, true
  float32 products on the CUDA cores, with ``cp.async``-staged tiles.

``attention_reference`` is the plain PyTorch version of the same
function: the port's copy of
``mxnet_tpu/parallel/ring_attention.py:attention_reference``, extended
to return the per-row logsumexp.

``flash_attention_bwd`` is the port of the JAX package's backward,
``_bwd_impl`` (the ``custom_vjp`` backward of ``flash_attention``).  The
dtype picks its kernel too:

- bfloat16: ``mxnet_tpu_torch/csrc/flash_attention_bwd_bf16.cu``, every
  product on the tensor cores (``wgmma``), fed by TMA;
- float32: ``mxnet_tpu_torch/csrc/flash_attention_bwd_f32.cu``, true
  float32 products on the CUDA cores, with ``cp.async``-staged tiles.

``attention_bwd_reference`` is its plain version, a port of
``_bwd_impl`` as a loop over key blocks.  :class:`FlashAttention`
pairs the two as a ``torch.autograd.Function``; :func:`flash_attention`
applies it.

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

__all__ = ["flash_attention", "FlashAttention", "flash_attention_fwd",
           "flash_attention_bwd", "attention_reference",
           "attention_bwd_reference", "kernel_route", "bwd_route",
           "LIBRARIES"]

MAX_HEAD_DIM = 128
_MAX_Q_TILES = 65535     # the kernels' grid limit on query tiles
_BWD_TILE = 64           # rows of the backward kernels' smallest tile
# the copies and TMA read 16-byte vectors: base addresses and strides
# must be multiples of this many bytes
_ALIGN = 16


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


def _declare(symbol):
    def declare(lib):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return declare


class _Kernel:
    """One CUDA source and its C entry, for one dtype."""

    def __init__(self, name, block_m):
        self.name = name
        self.symbol = "mxtt_" + name
        self.block_m = block_m      # query rows per block
        self.library = CudaLibrary(name, _declare(self.symbol))


_KERNELS = {
    torch.bfloat16: _Kernel("flash_attention_fwd_bf16", block_m=128),
    torch.float32: _Kernel("flash_attention_fwd_f32", block_m=64),
}


def _declare_bwd(symbol):
    def declare(lib):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        size = getattr(lib, symbol + "_workspace")
        size.argtypes = [ctypes.c_int] * 4
        size.restype = ctypes.c_longlong
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return declare


# the backward: one source and C entry per dtype, named as the kernel
BWD_NAMES = {torch.float32: "flash_attention_bwd_f32",
             torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_LIBRARIES = {dt: CudaLibrary(name, _declare_bwd("mxtt_" + name))
                  for dt, name in BWD_NAMES.items()}
# which of q, k, v, O, dO each backward kernel reads by 16-byte vectors
# (TMA for bfloat16, cp.async for float32); the others it reads by element
_BWD_VECTOR_READS = {torch.bfloat16: (False, True, True, False, True),
                     torch.float32: (True, True, True, False, True)}
LIBRARIES = tuple(kern.library for kern in _KERNELS.values()) \
    + tuple(_BWD_LIBRARIES.values())


def _needs_copy(x):
    """Whether the kernels cannot read ``x`` in place: its base address or
    the stride of a dimension longer than 1 is not a multiple of 16
    bytes, or such a stride is 0."""
    if x.data_ptr() % _ALIGN:
        return True
    size = x.element_size()
    return any(n > 1 and (st <= 0 or st * size % _ALIGN)
               for n, st in zip(x.shape[:3], x.stride()[:3]))


def kernel_route(q, k, v):
    """The kernel ``flash_attention_fwd`` launches for these inputs, and
    which of q, k, v it first copies; raises on what no kernel takes.

    Works on any device (meta tensors included), so the decision can be
    checked without a card."""
    kern = _KERNELS.get(q.dtype)
    if kern is None or not q.dtype == k.dtype == v.dtype:
        raise MXNetError("flash attention kernel takes float32 or bfloat16 "
                         "q, k, v of one dtype; got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise MXNetError("flash attention kernel takes 1 <= head_dim <= %d;"
                         " got %d" % (MAX_HEAD_DIM, q.shape[-1]))
    if -(-q.shape[1] // kern.block_m) > _MAX_Q_TILES:
        raise MXNetError("flash attention kernel takes t_q <= %d; got %d"
                         % (_MAX_Q_TILES * kern.block_m, q.shape[1]))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise MXNetError("flash attention kernel needs %s's last "
                             "dimension contiguous; got strides %s"
                             % (name, x.stride()))
    return kern.name, tuple(_needs_copy(x) for x in (q, k, v))


def _padded_copy(x):
    """A contiguous copy of ``x`` with head_dim zero-padded to a multiple
    of 8, so every stride is a multiple of 16 bytes in either dtype."""
    d = x.shape[-1]
    out = x.new_zeros(x.shape[:3] + (d + -d % 8,))
    out[..., :d] = x
    return out


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Exact attention forward; returns ``(o, lse)``.

    CUDA tensors run the hand-written kernel of their dtype (bfloat16 on
    the tensor cores, float32 on the CUDA cores), or raise: there is no
    fallback.  The kernels read 16-byte vectors, so an input whose base
    address or strides are not multiples of 16 bytes (head_dim 20 in
    bfloat16, for one) is first copied, once, into a contiguous buffer
    with head_dim zero-padded to a multiple of 8; the kernel then reads
    only its first head_dim columns.  That is a copy of the input, not a
    fallback: the same kernel runs.  The strided q, k, v views of a fused
    QKV projection need no copy.  CPU tensors run the plain version; meta
    tensors (shape inference) get empty outputs of the right shape.
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
    name, copies = kernel_route(q, k, v)
    q, k, v = (_padded_copy(x) if c else x for x, c in zip((q, k, v), copies))
    kern = _KERNELS[q.dtype]
    lib = kern.library.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, kern.symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, t_q, t_kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError("flash attention kernel %s launch failed: %s "
                         "(error %d)" % (name, lib.mxtt_cuda_error_string(
                             err).decode(), err))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.kernel_launches[name] += 1
    flash_attention_fwd.padded_copies += sum(copies)
    return o, lse


def attention_bwd_reference(q, k, v, o, lse, do, causal=False, scale=None,
                            block_k=128):
    """Plain backward of :func:`attention_reference`; returns
    ``(dq, dk, dv)`` in the inputs' dtype.

    A port of ``mxnet_tpu/op/pallas/flash_attention.py:_bwd_impl`` in
    the ``[b, t, h, d]`` layout, as a loop over blocks of ``block_k``
    keys, with its numerics: float32 inputs stay float32; bfloat16
    inputs feed each product in bfloat16 with float32 accumulation
    (``q * scale`` formed in float32 and rounded, P rounded before dV,
    dS before dQ and dK), here as float32 products of the rounded
    values; ``exp`` and dS stay float32.  A row whose lse is ``-inf``
    gets P = 0."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    narrow = q.dtype in (torch.bfloat16, torch.float16)

    def operand(x):
        """A product's operand: rounded to the input dtype, in float32."""
        return x.to(q.dtype).float() if narrow else x.float()

    qs = operand(q.float() * scale)
    do_m = operand(do)
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    lse = lse.reshape(b, h, t_q)
    live_row = ~torch.isneginf(lse)[..., None]
    q_pos = torch.arange(t_q, device=q.device)
    dq = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, t_kv, h, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, t_kv, block_k):
        kb, vb = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kb)
        live = live_row
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            live = live & (q_pos[:, None] >= k_pos[None, :])
        p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
        dv[:, k0:k0 + block_k] = torch.einsum("bhqk,bqhd->bkhd", operand(p),
                                              do_m)
        dp = torch.einsum("bqhd,bkhd->bhqk", do_m, vb)
        ds = operand(p * (dp - delta[..., None]))
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
        dk[:, k0:k0 + block_k] = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_route(q, k, v, o, do):
    """The kernel ``flash_attention_bwd`` launches for these inputs, and
    which of q, k, v, o, do it first copies; raises on what no kernel
    takes.

    A kernel reads some inputs by 16-byte vectors (bfloat16: k, v and do
    through TMA; float32: q, k, v and do through ``cp.async``): such an
    input is copied when its base address or a stride is not a multiple
    of 16 bytes (head_dim 20 in bfloat16, for one).  Any input whose last
    dimension is not contiguous is copied too.  Works on any device (meta
    tensors included), so the decision can be checked without a card."""
    xs = (q, k, v, o, do)
    name = BWD_NAMES.get(q.dtype)
    if name is None or any(x.dtype != q.dtype for x in xs):
        raise MXNetError("flash attention backward kernel takes float32 or "
                         "bfloat16 q, k, v, o, do of one dtype; got %s"
                         % [str(x.dtype) for x in xs])
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise MXNetError("flash attention backward kernel takes 1 <= "
                         "head_dim <= %d; got %d" % (MAX_HEAD_DIM,
                                                     q.shape[-1]))
    for t in (q.shape[1], k.shape[1]):
        if -(-t // _BWD_TILE) > _MAX_Q_TILES:
            raise MXNetError("flash attention backward kernel takes t <= %d;"
                             " got %d" % (_MAX_Q_TILES * _BWD_TILE, t))
    vector = _BWD_VECTOR_READS[q.dtype]
    return name, tuple(x.stride(-1) != 1 or (vec and _needs_copy(x))
                       for x, vec in zip(xs, vector))


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """The backward of :func:`flash_attention_fwd`: ``(dq, dk, dv)`` from
    the forward's inputs, its ``(o, lse)`` and the output gradient
    ``do``, all ``[b, t, h, d]`` but ``lse`` (``[b*h, t_q]`` float32).

    CUDA tensors run the hand-written kernel of their dtype or raise:
    there is no fallback.  The kernel reads every input through its
    strides; one that :func:`bwd_route` says it cannot read is first
    copied once, as :func:`flash_attention_fwd` copies (counted in
    ``flash_attention_bwd.copies``).  The same inputs give bitwise the
    same gradients every launch.  CPU tensors run the plain version.
    """
    _check_shapes(q, k, v)
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape:
        raise MXNetError("flash attention backward: o %s and do %s must have "
                         "q's shape %s" % (tuple(o.shape), tuple(do.shape),
                                           tuple(q.shape)))
    if lse.shape != (b * h, t_q):
        raise MXNetError("flash attention backward: lse %s, expected %s"
                         % (tuple(lse.shape), (b * h, t_q)))
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                       scale=scale)
    if q.device.type != "cuda":
        raise MXNetError("flash attention backward runs on cuda or cpu "
                         "tensors; got %s" % q.device)
    name, copies = bwd_route(q, k, v, o, do)
    if q.numel() == 0 or k.numel() == 0:
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    # the kernel writes every element of these
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    ins = [_padded_copy(x) if c else x
           for x, c in zip((q, k, v, o, do), copies)]
    lse = lse.float().contiguous()
    lib = _BWD_LIBRARIES[q.dtype].load()
    symbol = "mxtt_" + name
    workspace = torch.empty(getattr(lib, symbol + "_workspace")(b, h, t_q, d),
                            dtype=torch.uint8, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(st for x in ins
                                         for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = getattr(lib, symbol)(
            *(x.data_ptr() for x in ins), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), workspace.data_ptr(), b, h, t_q,
            t_kv, d, strides, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError("flash attention backward kernel %s launch failed: "
                         "%s (error %d)" % (name, lib.mxtt_cuda_error_string(
                             err).decode(), err))
    flash_attention_bwd.kernel_launches[name] += 1
    flash_attention_bwd.copies += sum(copies)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Exact attention whose forward is :func:`flash_attention_fwd` (K1)
    and whose backward is :func:`flash_attention_bwd` (B2): the port of
    the JAX package's ``_flash`` ``custom_vjp``.  CPU tensors take both
    plain versions; CUDA tensors take both kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable exact attention ``[b, t, h, d]`` -> ``[b, t_q, h,
    d]`` through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, causal, scale)


def reset_counts():
    """Set every count of ``flash_attention_fwd`` and
    ``flash_attention_bwd`` to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.kernel_launches = {
        kern.name: 0 for kern in _KERNELS.values()}
    flash_attention_fwd.padded_copies = 0
    flash_attention_bwd.kernel_launches = dict.fromkeys(BWD_NAMES.values(), 0)
    flash_attention_bwd.copies = 0


# kernel launches since the counts were last set to 0, in all and by
# kernel, and the inputs copied before a launch (the plain versions and
# meta inference never count)
reset_counts()
