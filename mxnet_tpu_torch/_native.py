"""The port's native image loader (``mxnet_tpu/_native.py``'s
``dataloader_lib``): ``csrc/dataloader.cc`` built with ``g++`` at first
use and bound with ``ctypes``.

The library lands in ``mxnet_tpu_torch/_build`` under a name that carries
the JPEG route and a digest of the source and the compile line, so an
edited source rebuilds by itself.  The JPEG route is libjpeg where its
header is on the compiler's path (the JAX package's decoder, bit for
bit), else nvJPEG from the CUDA toolkit (``$CUDA_HOME/include/nvjpeg.h``);
PNG decode is built in where libpng's header is found.  A host with
neither JPEG decoder, or a failed compile, raises :class:`MXNetError`
with the compiler's log: nothing falls back to a Python decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError
from .op.kernels.build import BUILD_DIR, CSRC

__all__ = ["dataloader_lib", "jpeg_route"]

SOURCE = CSRC / "dataloader.cc"
# the JAX package's Makefile flags: the libjpeg route's pixels match its
# package's build bit for bit only when the float resize compiles alike
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_LIB = None
_LOCK = threading.Lock()


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise MXNetError("the native image loader needs a C++ compiler "
                         "(g++ or $CXX), and none was found")
    return cxx


def _has_header(cxx, header):
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <%s>\n" % header,
                          capture_output=True, text=True)
    return proc.returncode == 0


def _cuda_home():
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _route_flags(cxx):
    """``(jpeg route, extra compile and link flags)`` for this host."""
    png = ("-DMXT_PNG",) if _has_header(cxx, "png.h") else ()
    png_lib = ("-lpng",) if png else ()
    if _has_header(cxx, "jpeglib.h"):
        return "libjpeg", png + ("-ljpeg",) + png_lib
    cuda = _cuda_home()
    if os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")):
        lib = os.path.join(cuda, "lib64")
        return "nvjpeg", png + (
            "-DMXT_NVJPEG", "-I" + os.path.join(cuda, "include"),
            "-L" + lib, "-Wl,-rpath," + lib, "-lnvjpeg", "-lcudart") + png_lib
    raise MXNetError(
        "the native image loader cannot decode JPEG on this host: "
        "libjpeg's header (jpeglib.h) is not on %s's path and the CUDA "
        "toolkit has no nvjpeg.h under %s" % (cxx, cuda))


def _declare(lib):
    c = ctypes
    lib.mxt_loader_create.restype = c.c_void_p
    lib.mxt_loader_create.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_float,
        c.POINTER(c.c_float), c.POINTER(c.c_float),
        c.c_int, c.c_uint32, c.c_int, c.c_int]
    lib.mxt_loader_count.restype = c.c_int64
    lib.mxt_loader_count.argtypes = [c.c_void_p]
    lib.mxt_loader_failures.restype = c.c_int64
    lib.mxt_loader_failures.argtypes = [c.c_void_p]
    lib.mxt_loader_reset.argtypes = [c.c_void_p]
    lib.mxt_loader_next.restype = c.c_int
    lib.mxt_loader_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                    c.POINTER(c.c_float)]
    lib.mxt_loader_next_u8.restype = c.c_int
    lib.mxt_loader_next_u8.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                                       c.POINTER(c.c_float)]
    lib.mxt_loader_free.argtypes = [c.c_void_p]
    lib.mxt_loader_set_layout.argtypes = [c.c_void_p, c.c_int]
    lib.mxt_loader_jpeg_route.restype = c.c_char_p
    lib.mxt_loader_jpeg_route.argtypes = []
    lib.mxt_loader_has_png.restype = c.c_int
    lib.mxt_loader_has_png.argtypes = []
    return lib


def _build():
    cxx = _cxx()
    route, extra = _route_flags(cxx)
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + extra).encode())
    out = BUILD_DIR / ("libdataloader-%s-%s.so"
                       % (route, digest.hexdigest()[:16]))
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    # the libraries go after the source, so the linker resolves them
    defines = [f for f in extra if f.startswith(("-D", "-I"))]
    libs = [f for f in extra if f not in defines]
    proc = subprocess.run([cxx, *CXX_FLAGS, *defines, "-o", str(tmp),
                           str(SOURCE), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError("building the native image loader (%s route) "
                         "failed:\n%s%s" % (route, proc.stdout, proc.stderr))
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or nothing
    return out


def dataloader_lib():
    """The native image loader library, built at first use.  Raises
    :class:`MXNetError` when it cannot be built."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _declare(ctypes.CDLL(str(_build())))
    return _LIB


def jpeg_route():
    """``"libjpeg"`` or ``"nvjpeg"``: the JPEG decoder of the built
    loader."""
    return dataloader_lib().mxt_loader_jpeg_route().decode()
