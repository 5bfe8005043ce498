#!/usr/bin/env python3
"""Time the attention backward kernels beside other versions of their sources.

Run from the root of a checkout, on a machine with a CUDA card and nvcc,
naming a directory of variant sources and their tags:

    python3 tools/torch_b2_variants.py chip_checkout/var onegrid,stages3

A variant is a file ``<dir>/<kernel>_<tag>.cu``, where ``<kernel>`` is
``flash_attention_bwd_f32`` or ``flash_attention_bwd_bf16``: a whole
source with the same C entries as ``mxnet_tpu_torch/csrc/<kernel>.cu``
(one that includes ``hopper.cuh`` names it by a path from its own
directory).  Each is built by nvcc with the port's flags.  In each
dtype, the current kernel and
every variant found are held against the plain version at every
``chip_smoke.CHECKS`` shape, launched twice to check that the gradients
are bitwise equal, then timed at the serving shapes of ``chip_smoke.py``
(4 x 1024 tokens, 12 heads of 64, causal) by ``chip_smoke.cuda_ms`` in
turns (current, the variants, the variants in reverse, current), with
the backward of ``scaled_dot_product_attention`` beside them; last each
is traced by ``torch.profiler`` for its device time by kernel.  It prints
the card's name and power limit, each library's registers and spills, one
JSON object per check and one per dtype (the times).  Nothing here is
used by the port.
"""
import json
import os
import sys

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mxnet_tpu_torch.op.kernels import build  # noqa: E402
from mxnet_tpu_torch.op.kernels import flash_attention as fa  # noqa: E402

CURRENT = "current"


def check(dtype):
    """The library now in use for ``dtype`` at every check shape: the
    shapes where it disagrees with the plain version or with itself."""
    bad = []
    for i, (label, b, t_q, t_kv, h, d, causal) in enumerate(chip_smoke.CHECKS):
        q, k, v = chip_smoke._qkv(b, t_q, t_kv, h, d, dtype, seed=i)
        o, lse = fa.attention_reference(q, k, v, causal=causal)
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        refs = fa.attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        close = all(torch.allclose(x.float(), r.float(),
                                   **chip_smoke.BWD_TOL[dtype])
                    for x, r in zip(first, refs))
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        if not (close and same):
            bad.append({"check": label, "close": close, "deterministic": same})
    return bad


def main(argv):
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_b2_variants: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    libs = {}
    for dtype, name in fa.BWD_NAMES.items():
        for tag in argv[2].split(","):
            path = os.path.join(argv[1], "%s_%s.cu" % (name, tag))
            if os.path.exists(path):
                libs[dtype, tag] = build.CudaLibrary(
                    "%s_%s" % (name, tag), fa._declare_bwd("mxtt_" + name),
                    source=path)
    build.build_all(list(fa.LIBRARIES) + list(libs.values()))
    for lib in list(fa.LIBRARIES) + list(libs.values()):
        if lib.build_seconds is not None and "bwd" in lib.name:
            print(json.dumps({lib.name: chip_smoke.ptxas_report(
                lib.build_log)}), flush=True)
    current = dict(fa._BWD_LIBRARIES)

    def use(dtype, tag):
        fa._BWD_LIBRARIES[dtype] = (current[dtype] if tag == CURRENT
                                    else libs[dtype, tag])

    b, t = chip_smoke.BATCH, chip_smoke.GPT2_SMALL["seq_len"]
    h = chip_smoke.GPT2_SMALL["num_heads"]
    d = chip_smoke.GPT2_SMALL["num_hidden"] // h
    try:
        for dtype in chip_smoke.DTYPES:
            tags = [CURRENT] + [tag for dt, tag in libs if dt == dtype]
            for tag in tags:
                use(dtype, tag)
                print(json.dumps({"variant": tag, "dtype": str(dtype),
                                  "bad": check(dtype)}), flush=True)
            q, k, v = chip_smoke._qkv(b, t, t, h, d, dtype, seed=100)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            g = torch.Generator(device="cuda").manual_seed(101)
            do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)

            def run():
                return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)

            ms = {tag: [] for tag in tags}
            for tag in tags + tags[::-1]:
                use(dtype, tag)
                ms[tag].append(chip_smoke.cuda_ms(run))
            leaves = [x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            do_t = do.transpose(1, 2)
            library_ms = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
                out, leaves, do_t, retain_graph=True))
            kernels = {}
            for tag in tags:
                use(dtype, tag)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run()
                    torch.cuda.synchronize()
                kernels[tag] = {e.key: e.self_device_time_total / 5e3
                                for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA
                                and e.self_device_time_total > 0}
            print(json.dumps({"dtype": str(dtype), "shape": [b, t, t, h, d],
                              "ms": ms, "sdpa_backward_ms": library_ms,
                              "kernel_ms": kernels, "card": card}),
                  flush=True)
            del out, leaves
    finally:
        fa._BWD_LIBRARIES.update(current)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
