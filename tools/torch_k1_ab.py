#!/usr/bin/env python3
"""Time the port's attention kernels beside the single SIMT kernel they replaced.

Run from the root of a checkout, on a machine with a CUDA card and nvcc,
naming a checkout of a commit that still has the earlier kernel, for
example one unpacked by ``git archive 5865bcc | tar -x -C chip_checkout/parent``:

    python3 tools/torch_k1_ab.py chip_checkout/parent

The earlier kernel is that checkout's
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``: one source for both
dtypes, computing both in float32 on the CUDA cores, behind the C entry
``mxtt_flash_attention_fwd`` that takes the dtype as an argument.  It is
built here beside the current kernels.  At the serving shapes of
``chip_smoke.py`` (4 x 1024 tokens, 12 heads of 64, causal, the strided
views of one fused qkv tensor) and in each dtype, both versions are first
held against the plain version, then timed in turns, earlier, current,
current, earlier, each by ``chip_smoke.cuda_ms``, with
``scaled_dot_product_attention`` on the same inputs beside them.  It prints
the card's name and power limit, then one JSON object per dtype.
"""
import ctypes
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mxnet_tpu_torch.op.kernels import build  # noqa: E402
from mxnet_tpu_torch.op.kernels import flash_attention as fa  # noqa: E402

_OLD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare_old(lib):
    fn = lib.mxtt_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def old_kernel(library):
    """The earlier kernel as a function of (q, k, v), causal, default
    scale; returns (o, lse)."""
    lib = library.load()

    def run(q, k, v):
        b, t_q, h, d = q.shape
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
        err = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, t_q, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / d ** 0.5, 1, _OLD_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("earlier kernel launch failed: error %d" % err)
        return o, lse
    return run


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    old_lib = build.CudaLibrary(
        "flash_attention_fwd_earlier", _declare_old,
        source=os.path.join(argv[1], "mxnet_tpu_torch", "csrc",
                            "flash_attention_fwd.cu"))
    build.build_all(list(fa.LIBRARIES) + [old_lib])
    old = old_kernel(old_lib)
    b, t = chip_smoke.BATCH, chip_smoke.GPT2_SMALL["seq_len"]
    h = chip_smoke.GPT2_SMALL["num_heads"]
    d = chip_smoke.GPT2_SMALL["num_hidden"] // h
    for dtype in chip_smoke.DTYPES:
        q, k, v = chip_smoke._qkv(b, t, t, h, d, dtype, seed=100)
        ref, ref_lse = fa.attention_reference(q, k, v, causal=True)
        errs = {}
        for name, fn in (("earlier", old),
                         ("current", lambda q, k, v: fa.flash_attention_fwd(
                             q, k, v, causal=True))):
            o, lse = fn(q, k, v)
            torch.cuda.synchronize()
            torch.testing.assert_close(o.float(), ref.float(),
                                       **chip_smoke.KERNEL_TOL[dtype])
            torch.testing.assert_close(lse, ref_lse, **chip_smoke.LSE_TOL)
            errs[name] = (o.float() - ref.float()).abs().max().item()
        ms = {"earlier": [], "current": []}
        for name in ("earlier", "current", "current", "earlier"):
            if name == "earlier":
                ms[name].append(chip_smoke.cuda_ms(lambda: old(q, k, v)))
            else:
                ms[name].append(chip_smoke.cuda_ms(
                    lambda: fa.flash_attention_fwd(q, k, v, causal=True)))
        library_ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True))
        bound_ms, bound_by = chip_smoke.attention_bound(b, t, t, h, d, True,
                                                        dtype)
        print(json.dumps({
            "ab": "flash_attention_fwd", "dtype": str(dtype),
            "shape": [b, t, t, h, d], "earlier_ms": ms["earlier"],
            "current_ms": ms["current"], "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": errs, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
