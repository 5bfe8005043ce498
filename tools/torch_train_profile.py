#!/usr/bin/env python3
"""Where a training step's time goes when the PyTorch port trains the LM.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/torch_train_profile.py [classic|fused|fused_bf16|resnet_bf16 ...]

For each mode named (the three LM modes by default) it builds the trained cell
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

``resnet_bf16`` profiles ``chip_smoke.py``'s ResNet cell instead
(ResNet-50, NHWC, batch 256 of 224 x 224, bfloat16 compute, SGD momentum,
one CUDA graph a step): STEPS replays timed on the host clock, TRACED
replays under the profiler (device busy and idle time, kernels by name),
three steps run eagerly (no graph) on the host clock, then one more eager
step under the profiler with every op body and
the update in a named range, so that each kernel is charged to a group:
convolutions (cuDNN's kernels and their layout transforms), BatchNorm
statistics and apply, ReLU / pooling / residual adds, the SGD update and
state writes, and the rest (the weights' casts to bfloat16, the loss
head, copies).  Backward kernels are charged by the autograd function
that launched them.
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
LM_MODES = list(MODES)
MODES["resnet_bf16"] = None

# ResNet groups: op bodies by registered name, backward functions by the
# autograd node that launched them
_OP_GROUP = {"Convolution": "convolutions", "BatchNorm": "batchnorm",
             "Activation": "relu_pool_add", "Pooling": "relu_pool_add",
             "_plus": "relu_pool_add"}
_BWD_GROUP = {"_ConvolutionFnBackward": "convolutions",
              "_BNTrainNormalizeBackward": "batchnorm",
              "ReluBackward0": "relu_pool_add",
              "ThresholdBackward0": "relu_pool_add",
              "MaxPool2DWithIndicesBackward0": "relu_pool_add",
              "AvgPool2DBackward0": "relu_pool_add",
              "AddBackward0": "relu_pool_add"}


def main():
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    modes = sys.argv[1:] or LM_MODES
    unknown = set(modes) - set(MODES)
    if unknown:
        print("torch_train_profile: unknown modes %s (of %s)"
              % (sorted(unknown), sorted(MODES)), file=sys.stderr)
        return 2
    card = chip_smoke.environment()
    chip_smoke.build_kernels()
    for mode in modes:
        if mode == "resnet_bf16":
            profile_resnet(card)
        else:
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


def _device_kernels(prof):
    return {e.key: e.self_device_time_total / 1e6
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _annotate_ops():
    """Wrap every op body of the ResNet groups, and the Trainer's update
    and state writes, in a named range; returns a function that undoes
    it."""
    from mxnet_tpu_torch.op import registry
    from mxnet_tpu_torch.parallel import trainer as trainer_mod
    undo = []
    for name, group in _OP_GROUP.items():
        op = registry.get(name)
        plain = op.fn

        def wrapped(*a, _fn=plain, _g=group):
            with record_function("group." + _g):
                return _fn(*a)

        op.fn = wrapped
        undo.append(lambda op=op, plain=plain: setattr(op, "fn", plain))
    cls = trainer_mod.Trainer
    for meth in ("_apply_update", "_write"):
        plain = getattr(cls, meth)

        def wrapped(self, *a, _fn=plain):
            with record_function("group.sgd_update_and_writes"):
                return _fn(self, *a)

        setattr(cls, meth, wrapped)
        undo.append(lambda m=meth, plain=plain: setattr(cls, m, plain))
    return lambda: [u() for u in undo]


def profile_resnet(card):
    """The ResNet cell's step: replays timed and traced, then one eager
    step traced with its kernels charged to groups."""
    mod, data, x, y, _ = chip_smoke.resnet_cell()
    tr = mod._trainer
    batch = {"data": x, "softmax_label": y}
    for _ in range(2):                       # eager step, then the capture
        tr.step(batch)
    torch.cuda.synchronize()
    replay_s = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        tr.step(batch)
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            tr.step(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_s = sum(kernels.values())
    # the same step run eagerly (no graph), on the host clock
    eager_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            tr._step_core(tr._device_batch(batch))
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    undo = _annotate_ops()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as eager:
            with torch.no_grad():
                tr._step_core(tr._device_batch(batch))
            torch.cuda.synchronize()
    finally:
        undo()
    eager_kernels = _device_kernels(eager)
    eager_busy = sum(eager_kernels.values())
    groups = {}
    for e in eager.key_averages():
        key = e.key
        if key.startswith("group."):
            group = key[len("group."):]
        elif key.startswith("autograd::engine::evaluate_function: "):
            group = _BWD_GROUP.get(key.split(": ", 1)[1])
        else:
            group = None
        if group is not None:
            groups[group] = groups.get(group, 0.0) + e.device_time_total / 1e6
    groups["other"] = eager_busy - sum(groups.values())
    # a copy of an activation per convolution would show here: the
    # weights' reshuffle to cuDNN's layout moves ~51 MB in bfloat16
    copies = {e.key: (e.count, e.device_time_total / 1e6)
              for e in eager.key_averages()
              if e.key in ("aten::copy_", "aten::contiguous", "aten::clone")}
    step_s = statistics.median(replay_s)
    print(json.dumps({
        "card": card, "cell": "resnet-50 train", "mode": "resnet_bf16",
        "batch": chip_smoke.RESNET_BATCH, "image": chip_smoke.RESNET_IMAGE,
        "graph_replays": tr.graph_replays,
        "replay_s_median": step_s, "replay_s_runs": replay_s,
        "img_per_s": chip_smoke.RESNET_BATCH / step_s,
        "traced_steps": TRACED, "wall_s_per_step": wall_s / TRACED,
        "device_busy_s_per_step": busy_s / TRACED,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "eager_step_s_runs": eager_s,
        "eager_step_device_busy_s": eager_busy,
        "eager_step_groups_s": dict(sorted(groups.items())),
        "eager_step_copy_calls_and_device_s": copies,
        "eager_step_copy_kernels_s": sum(v for k, v in eager_kernels.items()
                                         if "copy" in k.lower()),
        "kernels_s_per_step": {k: v / TRACED for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:40]},
    }), flush=True)
    del mod, data, tr


if __name__ == "__main__":
    sys.exit(main())
