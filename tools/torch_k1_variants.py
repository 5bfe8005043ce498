#!/usr/bin/env python3
"""Time the attention kernels beside copies of themselves with other tile
sizes or pipeline depths, to see what bounds each.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/torch_k1_variants.py

Each variant is a copy of a ``mxnet_tpu_torch/csrc`` source with one or
two constants replaced (``VARIANTS``), built by nvcc with the port's
flags into ``mxnet_tpu_torch/_build/variants``.  At the serving shapes of
``chip_smoke.py`` (4 x 1024 tokens, 12 heads of 64, causal, the strided
views of one fused qkv tensor) each variant is held against the plain
version with ``chip_smoke.py``'s tolerances, then all of a kernel's
variants are timed by ``chip_smoke.cuda_ms`` in turns, forwards and then
backwards.  It prints the card's name and power limit, one JSON object
per variant (registers, spills, errors) and one per kernel (the times).
A variant that disagrees with the plain version is reported and not
timed.  Nothing here is used by the port.
"""
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mxnet_tpu_torch.op.kernels import build  # noqa: E402
from mxnet_tpu_torch.op.kernels import flash_attention as fa  # noqa: E402

# (tag, [(text in the source, its replacement)]) per source; "as built"
# is the source unchanged
VARIANTS = {
    "flash_attention_fwd_f32": [
        ("as built", []),
        ("128-row Q tiles", [("constexpr int BLOCK_M = 64; ",
                              "constexpr int BLOCK_M = 128; ")]),
        ("8 rows a thread", [("constexpr int ROWS = 4;",
                              "constexpr int ROWS = 8;")]),
    ],
    "flash_attention_fwd_bf16": [
        ("as built", []),
        ("3 stages", [("constexpr int STAGES = 2;",
                       "constexpr int STAGES = 3;")]),
        ("4 stages", [("constexpr int STAGES = 2;",
                       "constexpr int STAGES = 4;")]),
        ("64-key tiles", [("D <= 64 ? 128 : 64;", "64;")]),
        ("64-key tiles, 4 stages", [("D <= 64 ? 128 : 64;", "64;"),
                                    ("constexpr int STAGES = 2;",
                                     "constexpr int STAGES = 4;")]),
    ],
}
OUT = build.BUILD_DIR / "variants"


def build_variant(name, index, subs):
    """Builds variant ``index`` of source ``name``; returns the library
    path and its ptxas report."""
    src = (build.CSRC / (name + ".cu")).read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError("%s: %r not in the source" % (name, old))
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / ("%s_%d.cu" % (name, index))
    path.write_text(src)
    lib = path.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (path, proc.stderr))
    return lib, chip_smoke.ptxas_report(proc.stderr)


def launcher(lib_path, name, q, k, v):
    """A function that runs the variant once on (q, k, v), causal."""
    lib = ctypes.CDLL(str(lib_path))
    symbol = "mxtt_" + name
    fa._declare(symbol)(lib)
    fn = getattr(lib, symbol)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, t, t, d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1.0 / d ** 0.5, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("%s launch failed: error %d" % (name, err))
        return o, lse
    return run


def main():
    if not torch.cuda.is_available():
        print("torch_k1_variants: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = {(name, i): pool.submit(build_variant, name, i, subs)
                 for name, variants in VARIANTS.items()
                 for i, (_, subs) in enumerate(variants)}
    b, t = chip_smoke.BATCH, chip_smoke.GPT2_SMALL["seq_len"]
    h = chip_smoke.GPT2_SMALL["num_heads"]
    d = chip_smoke.GPT2_SMALL["num_hidden"] // h
    for name, variants in VARIANTS.items():
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        q, k, v = chip_smoke._qkv(b, t, t, h, d, dtype, seed=100)
        ref, ref_lse = fa.attention_reference(q, k, v, causal=True)
        runs = {}
        for i, (tag, _) in enumerate(variants):
            lib_path, ptxas = built[(name, i)].result()
            run = launcher(lib_path, name, q, k, v)
            o, lse = run()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            right = torch.allclose(o.float(), ref.float(),
                                   **chip_smoke.KERNEL_TOL[dtype]) and \
                torch.allclose(lse, ref_lse, **chip_smoke.LSE_TOL)
            if right:
                runs[tag] = run
            print(json.dumps({"variant": tag, "kernel": name,
                              "ptxas": ptxas, "max_abs_err": err,
                              "lse_max_abs_err": lse_err, "right": right}),
                  flush=True)
        ms = {tag: [] for tag in runs}
        for order in (list(runs), list(runs)[::-1]):
            for tag in order:
                ms[tag].append(chip_smoke.cuda_ms(runs[tag]))
        bound_ms, bound_by = chip_smoke.attention_bound(b, t, t, h, d, True,
                                                        dtype)
        print(json.dumps({"kernel": name, "shape": [b, t, t, h, d],
                          "ms": ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
