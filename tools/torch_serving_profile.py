#!/usr/bin/env python3
"""Where a request's device time goes when the PyTorch port serves the LM.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/torch_serving_profile.py

It builds the ``gpt2-small`` cell of ``chip_smoke.py`` (the same widths,
seed, batch and requests), serves one request to warm up, then traces
the other requests with ``torch.profiler``.  It prints one JSON object:
the requests' wall time, the device time of every kernel by name (the
largest first) and in three groups (the flash-attention kernel, matrix
products, everything else), and the share of the wall time in which no
kernel ran.  The requests run one after another on one stream, so kernel
times do not overlap and their sum is the device's busy time.
"""
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _group(name):
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention_fwd"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matrix_products"
    return "other"


def main():
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    chip_smoke.build_kernels()
    _, pred, _, _, requests = chip_smoke.gpt2_small()
    pred.predict(data=requests[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ids in requests[1:]:
            pred.predict(data=ids)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = {e.key: e.self_device_time_total / 1e6
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups = {}
    for name, secs in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + secs
    busy_s = sum(kernels.values())
    n = len(requests) - 1
    print(json.dumps({
        "card": card, "cell": "gpt2-small", "batch": chip_smoke.BATCH,
        "seq_len": chip_smoke.GPT2_SMALL["seq_len"], "requests": n,
        "wall_s_per_request": wall_s / n,
        "device_busy_s_per_request": busy_s / n,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "groups_s_per_request": {k: v / n for k, v in sorted(groups.items())},
        "kernels_s_per_request": {k: v / n for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
