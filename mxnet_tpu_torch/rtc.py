"""Runtime-compiled kernels: the port of ``mxnet_tpu/rtc.py``.

The reference's ``mx.rtc`` (``python/mxnet/rtc.py``, ``src/common/
mxrtc.cc``, ``include/mxnet/mxrtc.h:26-81``) wraps a CUDA C kernel body
in a generated ``extern "C" __global__`` signature, one pointer per named
input and output, compiles it with NVRTC at runtime and launches it with
the grid and block given to ``push``.  The JAX package's TPU analog
compiles a Pallas body (``Rtc._compile_pallas``, its ``pl.pallas_call``
at ``mxnet_tpu/rtc.py:104``) or a ``jax.numpy`` body.  This port keeps
the reference's contract on the card:

* ``language="cuda"``: the kernel body is CUDA C.  It is decorated as
  ``extern "C" __global__ void <name>(const T_x* x, ..., T_y* y)``, each
  pointer typed from its prototype's dtype, with ``<name>_size``,
  ``<name>_ndim`` and ``<name>_shape`` constants for every input and
  output (what a Pallas body reads off its refs).  NVRTC compiles it for
  ``sm_90a`` when the Rtc is made; the CUDA driver API loads the cubin
  into torch's context and launches it on torch's current stream.
  Modules are cached by a digest of (source, options, device).
* ``language="torch"``: the body is Python statements over torch tensors
  bound by name, with ``torch``, ``F`` and ``math`` in scope; it must
  assign every output.  It is the CUDA body's plain version, runs on any
  device, and is what the CPU tests run.

There is no fallback between the two: a ``cuda`` kernel given CPU arrays
raises, and so does a machine without NVRTC.  ``Rtc.launches`` counts
kernel launches (the torch language never counts).

The kernel's work is the user's; what bounds it on the card is the
user's body (an elementwise body moves each input and output once, so
device memory at 3.35 TB/s bounds it).  The port's part is the compiler
call, the decoration, the module cache and the launch, all on the host.

Security note: like the reference, this compiles and runs the given
source in-process; only feed it trusted strings.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import sys
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Rtc", "decorate", "nvrtc_version"]

ARCH = "sm_90a"
# threads per block of the default launch: one thread per element of
# the first output
BLOCK = 256
# the C type each dtype's pointer has in a CUDA body
_CTYPES = {torch.float32: "float", torch.float64: "double",
           torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
           torch.int32: "int", torch.int64: "long long",
           torch.uint8: "unsigned char"}
_HEADERS = {torch.float16: "cuda_fp16.h", torch.bfloat16: "cuda_bf16.h"}
_IDENT = re.compile(r"[A-Za-z_]\w*\Z")


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _options():
    return ("--gpu-architecture=" + ARCH, "--std=c++17",
            "-I" + str(_cuda_home() / "include"))


def decorate(name, inputs, outputs, body) -> str:
    """The CUDA source NVRTC compiles for a kernel body.

    ``inputs`` and ``outputs`` are ``(name, shape, dtype)`` triples, in
    the order of the kernel's pointer parameters (inputs ``const``)."""
    for n in [name] + [a[0] for a in inputs + outputs]:
        if not _IDENT.match(n):
            raise MXNetError("rtc: %r is not a C identifier" % n)
    for n, _, dt in inputs + outputs:
        if dt not in _CTYPES:
            raise MXNetError("rtc: %s has dtype %s; cuda kernels take %s"
                             % (n, dt, sorted(map(str, _CTYPES))))
    headers = sorted({_HEADERS[dt] for _, _, dt in inputs + outputs
                      if dt in _HEADERS})
    params = ["const %s* %s" % (_CTYPES[dt], n) for n, _, dt in inputs] \
        + ["%s* %s" % (_CTYPES[dt], n) for n, _, dt in outputs]
    lines = ["#include <%s>" % h for h in headers]
    lines += ['extern "C" __global__ void %s(%s)' % (name, ", ".join(params)),
              "{"]
    for n, shape, _ in inputs + outputs:
        lines.append("    [[maybe_unused]] constexpr long long %s_size = %d;"
                     % (n, math.prod(shape)))
        lines.append("    [[maybe_unused]] constexpr int %s_ndim = %d;"
                     % (n, len(shape)))
        if shape:
            lines.append("    [[maybe_unused]] constexpr long long "
                         "%s_shape[%d] = {%s};"
                         % (n, len(shape), ", ".join(map(str, shape))))
    lines += [body, "}", ""]
    return "\n".join(lines)


# ----------------------------------------------------------------------
# NVRTC and the CUDA driver, bound with ctypes at first use
_LOCK = threading.Lock()
_LIBS = {}
# device index -> its retained primary context
_PRIMARY = {}
# digest of (source, options, device) -> CUfunction handle; modules stay
# loaded for the life of the process, as the reference's cache keeps them
_FUNCTIONS = {}


def _nvrtc_dirs():
    """Where libnvrtc is looked for: the toolkit's ``$CUDA_HOME/lib64``,
    then the ``nvidia/cuda_nvrtc/lib`` of a pip-installed CUDA runtime
    (the one torch's wheels bring)."""
    return [_cuda_home() / "lib64"] + [Path(p) / "nvidia" / "cuda_nvrtc" /
                                       "lib" for p in sys.path if p]


def _find_nvrtc() -> str:
    for d in _nvrtc_dirs():
        hits = sorted(d.glob("libnvrtc.so*"))
        if hits:
            return str(hits[0])
    raise MXNetError(
        "NVRTC (libnvrtc.so) not found under $CUDA_HOME/lib64 (%s) nor "
        "in a pip nvidia/cuda_nvrtc/lib; the cuda rtc language needs it"
        % (_cuda_home() / "lib64"))


def _nvrtc():
    lib = _LIBS.get("nvrtc")
    if lib is None:
        lib = ctypes.CDLL(_find_nvrtc())
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.nvrtcGetErrorString.argtypes = [I]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcVersion.argtypes = [ctypes.POINTER(I)] * 2
        lib.nvrtcCreateProgram.argtypes = [ctypes.POINTER(P), ctypes.c_char_p,
                                           ctypes.c_char_p, I, P, P]
        lib.nvrtcCompileProgram.argtypes = [P, I,
                                            ctypes.POINTER(ctypes.c_char_p)]
        lib.nvrtcGetProgramLogSize.argtypes = [P, ctypes.POINTER(S)]
        lib.nvrtcGetProgramLog.argtypes = [P, ctypes.c_char_p]
        lib.nvrtcGetCUBINSize.argtypes = [P, ctypes.POINTER(S)]
        lib.nvrtcGetCUBIN.argtypes = [P, ctypes.c_char_p]
        lib.nvrtcDestroyProgram.argtypes = [ctypes.POINTER(P)]
        _LIBS["nvrtc"] = lib
    return lib


def _check_nvrtc(rc, what):
    if rc != 0:
        raise MXNetError("%s failed: %s (nvrtcResult %d)" % (
            what, _nvrtc().nvrtcGetErrorString(rc).decode(), rc))


def nvrtc_version():
    """``(major, minor)`` of the NVRTC this process compiles with."""
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(_nvrtc().nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _compile(name, source, options) -> bytes:
    """NVRTC: CUDA C source -> cubin for ``ARCH``; raises with the
    program log on a compile error."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        (name + ".cu").encode(), 0, None,
                                        None), "nvrtcCreateProgram")
    try:
        opts = [o.encode() for o in options]
        rc = lib.nvrtcCompileProgram(prog, len(opts),
                                     (ctypes.c_char_p * len(opts))(*opts))
        if rc != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            raise MXNetError("NVRTC could not compile rtc kernel %s (%s):\n"
                             "%s\n--- source ---\n%s"
                             % (name, lib.nvrtcGetErrorString(rc).decode(),
                                log.value.decode(errors="replace"), source))
        size = ctypes.c_size_t()
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _driver():
    lib = _LIBS.get("cuda")
    if lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.cuGetErrorString.argtypes = [I, ctypes.POINTER(ctypes.c_char_p)]
        lib.cuInit.argtypes = [U]
        lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(P)]
        lib.cuCtxSetCurrent.argtypes = [P]
        lib.cuDeviceGet.argtypes = [ctypes.POINTER(I), I]
        lib.cuDevicePrimaryCtxRetain.argtypes = [ctypes.POINTER(P), I]
        lib.cuModuleLoadData.argtypes = [ctypes.POINTER(P), ctypes.c_char_p]
        lib.cuModuleGetFunction.argtypes = [ctypes.POINTER(P), P,
                                            ctypes.c_char_p]
        lib.cuLaunchKernel.argtypes = [P] + [U] * 7 + [
            P, ctypes.POINTER(P), ctypes.POINTER(P)]
        _check_cu(lib, lib.cuInit(0), "cuInit")
        _LIBS["cuda"] = lib
    return lib


def _check_cu(lib, rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise MXNetError("%s failed: %s (CUresult %d)"
                         % (what, (msg.value or b"unknown").decode(), rc))


def _bind_context(device: torch.device):
    """Make torch's context of ``device`` (its primary context) current
    in this thread, for the driver calls that follow."""
    cu = _driver()
    cur = ctypes.c_void_p()
    _check_cu(cu, cu.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if not cur.value:
        # a thread the runtime has not bound yet: bind the primary
        # context, the one torch uses, retained once per device
        ctx = _PRIMARY.get(device.index)
        if ctx is None:
            dev = ctypes.c_int()
            _check_cu(cu, cu.cuDeviceGet(ctypes.byref(dev), device.index),
                      "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check_cu(cu, cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                      dev.value),
                      "cuDevicePrimaryCtxRetain")
            _PRIMARY[device.index] = ctx
        _check_cu(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return cu


def _load(name, source, device: torch.device):
    """The kernel's CUfunction on ``device``, from the cache or compiled
    and loaded now; returns ``(function, compile_ms, load_ms)`` with both
    times None on a cache hit."""
    options = _options()
    key = hashlib.sha256("\0".join(
        (source, " ".join(options), str(device))).encode()).hexdigest()
    with _LOCK:
        fn = _FUNCTIONS.get(key)
        if fn is not None:
            return fn, None, None
        t0 = time.perf_counter()
        cubin = _compile(name, source, options)
        t1 = time.perf_counter()
        torch.cuda.init()
        with torch.cuda.device(device):
            cu = _bind_context(device)
            module = ctypes.c_void_p()
            _check_cu(cu, cu.cuModuleLoadData(ctypes.byref(module), cubin),
                      "cuModuleLoadData")
            fn = ctypes.c_void_p()
            _check_cu(cu, cu.cuModuleGetFunction(ctypes.byref(fn), module,
                                                 name.encode()),
                      "cuModuleGetFunction")
        _FUNCTIONS[key] = fn
        return fn, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def _dims(v, what):
    if v is None or len(v) != 3 or any(int(d) < 1 for d in v):
        raise MXNetError("rtc: %s must be 3 positive ints; got %r"
                         % (what, v))
    return tuple(int(d) for d in v)


# ----------------------------------------------------------------------
def _tensor(a) -> torch.Tensor:
    return a.data if isinstance(a, NDArray) else torch.as_tensor(a)


def _write(out, val):
    """Write a result into an output (NDArray or tensor), casting to its
    dtype; a shape mismatch raises."""
    target = out.data if isinstance(out, NDArray) else out
    val = torch.as_tensor(val, device=target.device)
    if tuple(val.shape) != tuple(target.shape):
        raise MXNetError("rtc: result of shape %s for an output of shape %s"
                         % (tuple(val.shape), tuple(target.shape)))
    if isinstance(out, NDArray):
        out._set_data(val)
    else:
        target.copy_(val)


class Rtc(object):
    """A runtime-compiled kernel (reference ``rtc.py:10-91``).

    Parameters
    ----------
    name : str
        the kernel's name; for ``cuda`` its C function name, which must
        not be one of CUDA's own (``sincos``, ``sinf``...).
    inputs, outputs : list of (name, NDArray or tensor)
        names bound in the kernel; the arrays are shape/dtype prototypes,
        and for ``cuda`` their device is the kernel's.
    kernel : str
        the body: CUDA C for ``language="cuda"``, Python statements over
        torch tensors for ``language="torch"``.
    """

    # kernel launches since the count was last set to 0
    launches = 0

    def __init__(self, name, inputs, outputs, kernel, language="cuda"):
        self.name = name
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        self._in_protos = [(tuple(_tensor(a).shape), _tensor(a).dtype)
                           for _, a in inputs]
        self._out_protos = [(tuple(_tensor(a).shape), _tensor(a).dtype)
                            for _, a in outputs]
        self.kernel = kernel
        self.language = language
        # NVRTC and module-load times of this Rtc's last new module (ms);
        # None when the module came from the cache
        self.compile_ms = self.load_ms = None
        if language == "torch":
            self._code = compile(kernel, "<rtc:%s>" % name, "exec")
        elif language == "cuda":
            if not outputs:
                raise MXNetError("rtc %s: a cuda kernel needs an output"
                                 % name)
            devices = {_tensor(a).device for _, a in inputs + outputs}
            if len(devices) != 1 or next(iter(devices)).type != "cuda":
                raise MXNetError(
                    "rtc %s: a cuda kernel takes arrays on one CUDA device; "
                    "got %s (language='torch' runs anywhere)"
                    % (name, sorted(map(str, devices))))
            self.device = next(iter(devices))
            self._functions = {}
            self._function(tuple(self._in_protos) + tuple(self._out_protos))
        elif language == "pallas":
            raise MXNetError("rtc %s: Pallas kernels run on a TPU; on a CUDA "
                             "card write the body in CUDA C "
                             "(language='cuda')" % name)
        else:
            raise MXNetError("unknown rtc language %r (cuda or torch)"
                             % (language,))

    def _source(self, sig) -> str:
        """The decorated CUDA source for a signature: (shape, dtype) of
        each input, then of each output."""
        n_in = len(self.input_names)
        return decorate(
            self.name,
            [(n, s, d) for n, (s, d) in zip(self.input_names, sig[:n_in])],
            [(n, s, d) for n, (s, d) in zip(self.output_names, sig[n_in:])],
            self.kernel)

    def _function(self, sig):
        fn = self._functions.get(sig)
        if fn is None:
            fn, compile_ms, load_ms = _load(self.name, self._source(sig),
                                            self.device)
            self.compile_ms, self.load_ms = compile_ms, load_ms
            self._functions[sig] = fn
        return fn

    # -- execution -----------------------------------------------------
    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Run the kernel on ``ins``, writing ``outs``.

        ``cuda``: ``grid_dims``/``block_dims`` (3-tuples) are the launch's,
        exactly; with both None, one thread per element of the first
        output, ``BLOCK`` per block.  Inputs that are not contiguous are
        copied first; an output that is not contiguous, or not of its
        prototype's dtype, is written through a contiguous temporary.
        Inputs or outputs of other shapes or dtypes than the prototypes
        compile another module, as ``jax.jit`` retraces."""
        if len(ins) != len(self.input_names) or \
                len(outs) != len(self.output_names):
            raise MXNetError("rtc %s: expected %d inputs / %d outputs"
                             % (self.name, len(self.input_names),
                                len(self.output_names)))
        if self.language == "torch":
            return self._push_torch(ins, outs)
        return self._push_cuda(ins, outs, grid_dims, block_dims)

    __call__ = push

    def _push_torch(self, ins, outs):
        env = {"torch": torch, "F": F, "math": math}
        env.update(zip(self.input_names, (_tensor(a) for a in ins)))
        exec(self._code, env)
        missing = [n for n in self.output_names if n not in env]
        if missing:
            raise MXNetError("rtc kernel %s did not assign outputs %s"
                             % (self.name, missing))
        for out, n in zip(outs, self.output_names):
            _write(out, env[n])
        return outs

    def _push_cuda(self, ins, outs, grid_dims, block_dims):
        in_t = [_tensor(a) for a in ins]
        out_t = [_tensor(a) for a in outs]
        for t in in_t + out_t:
            if t.device != self.device:
                raise MXNetError("rtc %s: a cuda kernel of %s got an array "
                                 "on %s" % (self.name, self.device, t.device))
        for o in outs:
            if isinstance(o, NDArray) and not o._writable:
                raise MXNetError("trying to write to a read-only NDArray")
        in_t = [t.contiguous() for t in in_t]
        sig = tuple((tuple(t.shape), t.dtype) for t in in_t) + tuple(
            (tuple(o.shape), dt) for o, (_, dt) in zip(out_t,
                                                       self._out_protos))
        fn = self._function(sig)
        staged = [o if o.is_contiguous() and o.dtype == dt
                  else torch.empty(o.shape, dtype=dt, device=self.device)
                  for o, (_, dt) in zip(out_t, self._out_protos)]
        if grid_dims is None and block_dims is None:
            n = staged[0].numel()
            if n == 0:
                return outs
            grid, block = (-(-n // BLOCK), 1, 1), (BLOCK, 1, 1)
        else:
            grid, block = _dims(grid_dims, "grid_dims"), \
                _dims(block_dims, "block_dims")
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in in_t + staged]
        params = (ctypes.c_void_p * len(ptrs))(
            *[ctypes.addressof(p) for p in ptrs])
        with torch.cuda.device(self.device):
            cu = _bind_context(self.device)
            _check_cu(cu, cu.cuLaunchKernel(
                fn, *grid, *block, 0,
                torch.cuda.current_stream(self.device).cuda_stream,
                params, None), "cuLaunchKernel of rtc kernel %s" % self.name)
        Rtc.launches += 1
        for o, s in zip(out_t, staged):
            if s is not o:
                o.copy_(s)
        return outs
