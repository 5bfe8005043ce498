#!/usr/bin/env python3
"""How much of the plain attention versions' time in ``chip_smoke.py``'s
kernel line is the host's: the measurement behind the plain columns of
PERF.md's kernel table.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_plain_attention_timing.py

At ``chip_smoke.py``'s timing shape (4 x 1024 x 1024, 12 heads of 64,
causal), for bfloat16 and float32, each plain version (the forward
``attention_reference``, K1's, and the backward
``attention_bwd_reference``, B2's; both pure PyTorch, so nothing is
built) is timed three ways, the median of 20 each:

* ``events_ms``: ``chip_smoke.cuda_ms``, CUDA events around each call
  behind a spin of the stream, as the kernel line is timed;
* ``host_enqueue_ms``: the host's wall time to return from the call, with
  no synchronisation (the time to enqueue its kernels);
* ``graph_ms``: CUDA events around one replay of a CUDA graph of the
  call, the device's time with no host in the way.

One JSON line a (version, dtype), with the card's name and power limit.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from mxnet_tpu_torch.op.kernels import flash_attention as fa  # noqa: E402

ITERS = 20


def host_enqueue_ms(fn):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(out)


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return chip_smoke.cuda_ms(graph.replay, iters=ITERS)


def _or_error(measure, fn):
    try:
        return measure(fn)
    except Exception as err:    # noqa: BLE001 - reported in the line
        return "%s: %s" % (type(err).__name__, err)


def main():
    if not torch.cuda.is_available():
        print("torch_plain_attention_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    b, t, h = chip_smoke.BATCH, chip_smoke.GPT2_SMALL["seq_len"], \
        chip_smoke.GPT2_SMALL["num_heads"]
    d = chip_smoke.GPT2_SMALL["num_hidden"] // h
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = chip_smoke._qkv(b, t, t, h, d, dtype, seed=100)
        o, lse = fa.attention_reference(q, k, v, causal=True)
        g = torch.Generator(device="cuda").manual_seed(101)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        versions = {
            "plain K1 (attention_reference)":
                lambda: fa.attention_reference(q, k, v, causal=True),
            "plain B2 (attention_bwd_reference)":
                lambda: fa.attention_bwd_reference(q, k, v, o, lse, do,
                                                   causal=True)}
        for name, fn in versions.items():
            print(json.dumps({
                "version": name, "dtype": str(dtype), "shape": [b, t, t, h, d],
                "events_ms": chip_smoke.cuda_ms(fn, iters=ITERS),
                "host_enqueue_ms": host_enqueue_ms(fn),
                "graph_ms": _or_error(graph_ms, fn), "card": card}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
