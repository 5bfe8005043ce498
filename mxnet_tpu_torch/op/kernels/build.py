"""Build the CUDA sources of ``mxnet_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, bound with ``ctypes``.
The library lands in ``mxnet_tpu_torch/_build`` under a name that carries
a digest of its source, the headers it includes and the flags: an edited
source or header is rebuilt, an unchanged one is loaded as it stands.
Nothing is built at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Sequence

from ...base import MXNetError

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


# a header included by quotes: resolved beside the file that includes it
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_digest(source: Path) -> str:
    """A digest of ``source``, of every header it includes by quotes
    (recursively, each once) and of ``NVCC_FLAGS``."""
    digest = hashlib.sha256()
    seen = set()

    def add(path: Path) -> None:
        path = path.resolve()
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        digest.update(text)
        for name in _LOCAL_INCLUDE.findall(text.decode()):
            add(path.parent / name)

    add(Path(source))
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source (or another ``source`` path), built
    and loaded at first use.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's
    C functions once, right after it is loaded."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 source: Path = None):
        self.name = name
        self.source = Path(source) if source else CSRC / (name + ".cu")
        self._declare = declare
        # the built shared library, once loaded
        self.path = None
        # seconds nvcc took in this process; None when the library was
        # already built
        self.build_seconds = None
        self.build_log = ""
        self._lib = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.path = self._build()
            lib = ctypes.CDLL(str(self.path))
            self._declare(lib)
            self._lib = lib
        return self._lib

    def _build(self) -> Path:
        src = self.source
        out = BUILD_DIR / ("lib%s-%s.so" % (self.name, source_digest(src)))
        if out.exists():
            return out
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed on %s:\n%s%s"
                             % (src, proc.stdout, proc.stderr))
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        return out


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every library at once, one ``nvcc`` per source."""
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
