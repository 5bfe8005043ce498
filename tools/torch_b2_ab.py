#!/usr/bin/env python3
"""Time the port's attention backward kernels beside the SIMT source they
replaced.

Run from the root of a checkout, on a machine with a CUDA card and nvcc,
naming a checkout of a commit that still has the earlier kernel, for
example one unpacked by
``git archive fef98a1 | tar -x -C chip_checkout/parent``:

    python3 tools/torch_b2_ab.py chip_checkout/parent

The earlier kernel is that checkout's
``mxnet_tpu_torch/csrc/flash_attention_bwd.cu``: one source templated over
both dtypes, computing both in float32 on the CUDA cores, behind the C
entries ``mxtt_flash_attention_bwd_f32`` and ``mxtt_flash_attention_bwd_bf16``
that take a float32 [b*h, t_q] scratch buffer for delta.  It is built here
beside the current kernels.  At the serving shapes of ``chip_smoke.py``
(4 x 1024 tokens, 12 heads of 64, causal, the strided views of one fused
qkv tensor) and in each dtype, both versions are first held against the
plain version, then timed in turns, earlier, current, current, earlier,
each by ``chip_smoke.cuda_ms``, with the backward of
``scaled_dot_product_attention`` on the same inputs beside them.  It
prints the card's name and power limit, then one JSON object per dtype.
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


def _declare_old(lib):
    for name in fa.BWD_NAMES.values():
        fn = getattr(lib, "mxtt_" + name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int


def old_kernel(library):
    """The earlier kernel as a function of (q, k, v, o, lse, do), causal,
    default scale; returns (dq, dk, dv)."""
    lib = library.load()

    def run(q, k, v, o, lse, do):
        b, t_q, h, d = q.shape
        outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                for x in (q, k, v)]
        delta = torch.empty((b * h, t_q), dtype=torch.float32,
                            device=q.device)
        strides = (ctypes.c_longlong * 15)(*(st for x in (q, k, v, o, do)
                                             for st in x.stride()[:3]))
        err = getattr(lib, "mxtt_" + fa.BWD_NAMES[q.dtype])(
            *(x.data_ptr() for x in (q, k, v, o, do)), lse.data_ptr(),
            *(x.data_ptr() for x in outs), delta.data_ptr(), b, h, t_q,
            k.shape[1], d, strides, 1.0 / d ** 0.5, 1,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("earlier kernel launch failed: error %d" % err)
        return outs
    return run


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_b2_ab: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    old_lib = build.CudaLibrary(
        "flash_attention_bwd_earlier", _declare_old,
        source=os.path.join(argv[1], "mxnet_tpu_torch", "csrc",
                            "flash_attention_bwd.cu"))
    build.build_all(list(fa.LIBRARIES) + [old_lib])
    old = old_kernel(old_lib)
    b, t = chip_smoke.BATCH, chip_smoke.GPT2_SMALL["seq_len"]
    h = chip_smoke.GPT2_SMALL["num_heads"]
    d = chip_smoke.GPT2_SMALL["num_hidden"] // h

    def current(q, k, v, o, lse, do):
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)

    for dtype in chip_smoke.DTYPES:
        q, k, v = chip_smoke._qkv(b, t, t, h, d, dtype, seed=100)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        g = torch.Generator(device="cuda").manual_seed(101)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        args = (q, k, v, o, lse, do)
        refs = fa.attention_bwd_reference(*args, causal=True)
        errs = {}
        for name, fn in (("earlier", old), ("current", current)):
            grads = fn(*args)
            torch.cuda.synchronize()
            for x, r in zip(grads, refs):
                torch.testing.assert_close(x.float(), r.float(),
                                           **chip_smoke.BWD_TOL[dtype])
            errs[name] = max((x.float() - r.float()).abs().max().item()
                             for x, r in zip(grads, refs))
        ms = {"earlier": [], "current": []}
        for name in ("earlier", "current", "current", "earlier"):
            fn = old if name == "earlier" else current
            ms[name].append(chip_smoke.cuda_ms(lambda: fn(*args)))
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        do_t = do.transpose(1, 2)
        library_ms = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do_t, retain_graph=True))
        bound_ms, bound_by = chip_smoke.attention_bound(b, t, t, h, d, True,
                                                        dtype, backward=True)
        print(json.dumps({
            "ab": "flash_attention_bwd", "dtype": str(dtype),
            "shape": [b, t, t, h, d], "earlier_ms": ms["earlier"],
            "current_ms": ms["current"], "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": errs, "card": card}), flush=True)
        del out, leaves
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
