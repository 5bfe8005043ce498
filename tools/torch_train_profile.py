#!/usr/bin/env python3
"""Where a training step's time goes when the PyTorch port trains the LM.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/torch_train_profile.py [classic|fused|fused_bf16 ...]

For each mode named (all three by default) it builds the trained cell
of ``chip_smoke.py`` (GPT-2 small's widths and depth, batch 4 x 1024
tokens, Adam; the same seed and batches): ``classic`` on the executor
path (``MXTPU_MODULE_FUSED=never``), ``fused`` through the fused
Trainer, whose step is one CUDA graph, and ``fused_bf16`` the same with
``compute_dtype="bfloat16"``.  It takes two warm-up steps (on the fused
path: the eager step and the capture).  Then, for STEPS steps, it times
each phase of ``Module.fit``'s step on the host clock, with the stream
synchronised around it: forward (``is_train=True``; on the fused path
it only stages the batch), backward (nothing on the fused path), the
optimizer update (the fused path's whole step, a graph replay) and the
metric update.  Last it traces two more steps
with ``torch.profiler``.  It prints one JSON object: the median of each
phase, the traced steps' wall time, the device time of every kernel by
name (the largest first) and in groups (the attention forward K1, the
attention backward B2, matrix products, everything else), and the share
of the wall time in which no kernel ran.  One stream runs everything, so
kernel times do not overlap and their sum is the device's busy time.
One JSON object a mode.
"""
import json
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

STEPS = 5
TRACED = 2


def _group(name):
    low = name.lower()
    if "flash_fwd" in name:
        return "K1 flash_attention_fwd"
    if "flash_bwd" in name:   # flash_bwd_{delta,prep,dkdv,dq}_{f32,bf16}
        return "B2 flash_attention_bwd"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matrix_products"
    return "other"


def _batches(data):
    while True:
        data.reset()
        yield from data


MODES = {"classic": dict(fused=False), "fused": dict(fused=True),
         "fused_bf16": dict(fused=True, compute_dtype="bfloat16")}


def main():
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    modes = sys.argv[1:] or list(MODES)
    unknown = set(modes) - set(MODES)
    if unknown:
        print("torch_train_profile: unknown modes %s (of %s)"
              % (sorted(unknown), sorted(MODES)), file=sys.stderr)
        return 2
    card = chip_smoke.environment()
    chip_smoke.build_kernels()
    for mode in modes:
        profile_mode(card, mode)
        torch.cuda.empty_cache()
    return 0


def profile_mode(card, mode):
    mod, data, _, _, _ = chip_smoke.gpt2_train_cell(**MODES[mode])
    metric = mt.metric.Perplexity(None)
    batches = _batches(data)

    def step(timed=None):
        batch = next(batches)
        for name, fn in (("forward", lambda: mod.forward(batch,
                                                         is_train=True)),
                         ("backward", mod.backward),
                         ("update", mod.update),
                         ("metric", lambda: mod.update_metric(
                             metric, batch.label))):
            t0 = time.perf_counter()
            with record_function("step." + name):
                fn()
            if timed is not None:
                torch.cuda.synchronize()
                timed.setdefault(name, []).append(time.perf_counter() - t0)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    phases = {}
    for _ in range(STEPS):
        step(phases)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the phases' record_function ranges carry their kernels' device time
    # too: they are annotations, not kernels
    kernels = {e.key: e.self_device_time_total / 1e6
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("step.")}
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups = {}
    for name, secs in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + secs
    busy_s = sum(kernels.values())
    trainer = mod._trainer
    print(json.dumps({
        "card": card, "cell": "gpt2-small train", "mode": mode,
        "graph_replays": trainer.graph_replays if trainer else None,
        "batch": chip_smoke.BATCH,
        "seq_len": chip_smoke.GPT2_SMALL["seq_len"],
        "phase_s_median": {k: statistics.median(v)
                           for k, v in phases.items()},
        "phase_s_runs": phases, "traced_steps": TRACED,
        "wall_s_per_step": wall_s / TRACED,
        "device_busy_s_per_step": busy_s / TRACED,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "groups_s_per_step": {k: v / TRACED
                              for k, v in sorted(groups.items())},
        "kernels_s_per_step": {k: v / TRACED for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:40]},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
