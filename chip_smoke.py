#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises (a non-zero exit, no result line) when it
fails:

1. environment: the card's name and power limit; TF32 off for matrix
   products and convolutions, so float32 means float32;
2. build: every CUDA kernel of the serving path, from
   ``mxnet_tpu_torch/csrc``, one nvcc per source, all at once;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the serving shapes and at ragged, cross-shaped and other
   head-dim shapes, in float32 and bfloat16;
4. serve: the transformer LM at GPT-2 small's published widths, random
   weights from a seed, saved as ``-symbol.json`` + ``.params`` and
   loaded by ``Predictor.from_checkpoint`` onto the card; three requests
   of 4 x 1024 tokens, with each kernel's launches counted, and the
   logits held against the port's own CPU run of one request;
5. times: each kernel, its plain version and the PyTorch library call
   that computes the same function, at the serving shapes; the
   Predictor's requests/s and tokens/s.

The line before the last is one JSON object with a record per kernel;
the last line names the device.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.op.kernels import build
from mxnet_tpu_torch.op.kernels import flash_attention as fa

# openai-community/gpt2 config.json: n_embd 768, n_head 12, n_layer 12,
# n_positions 1024, vocab_size 50257
GPT2_SMALL = dict(seq_len=1024, num_hidden=768, num_heads=12, num_layers=12,
                  vocab_size=50257)
BATCH = 4
REQUESTS = 3
SEED = 0
# H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit):
# device memory, and arithmetic per dtype (float32 on the CUDA cores,
# bfloat16 on the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel vs plain version on the same inputs.  float32: both accumulate in
# float32 in another order, ~1e-6 apart; a wrong mask, tile or scale is
# off by 1e-1 or more.  bfloat16: both round O to bfloat16 (one ulp is
# 2^-8 relative) and the kernel rounds P to bfloat16 before P V as the
# TPU kernel does; lse is float32 from exact bfloat16 products.
KERNEL_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-5),
              torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# GPU (kernels, cuBLAS without TF32) vs CPU (plain versions) float32
# logits after 12 blocks: products and sums in another order.  A bfloat16
# computation misses it: rounding the logits alone to bfloat16 breaks it,
# which the serve phase checks.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=1e-4, atol=1e-9)

# (label, b, t_q, t_kv, h, d, causal, dtype); the first two are the
# serving shapes, read through the strided views of one fused qkv tensor
# as the attention block hands them to the kernel
CHECKS = [
    ("serving", 4, 1024, 1024, 12, 64, True, torch.float32),
    ("serving", 4, 1024, 1024, 12, 64, True, torch.bfloat16),
    ("ragged", 3, 300, 451, 5, 64, False, torch.float32),
    ("ragged", 3, 300, 451, 5, 64, False, torch.bfloat16),
    ("causal_tq_lt_tkv", 2, 130, 320, 4, 64, True, torch.float32),
    ("causal_tq_gt_tkv", 2, 320, 130, 4, 64, True, torch.float32),
    ("head_dim_128", 2, 512, 512, 4, 128, True, torch.float32),
    ("head_dim_128", 2, 512, 512, 4, 128, True, torch.bfloat16),
    ("head_dim_16", 2, 100, 77, 3, 16, False, torch.float32),
    ("head_dim_32", 2, 96, 96, 3, 32, True, torch.bfloat16),
    ("head_dim_40_padded", 2, 65, 65, 2, 40, True, torch.float32),
]


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _phase(name):
    print("== %s" % name, flush=True)


def _qkv(b, t_q, t_kv, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if t_q == t_kv:
        qkv = torch.randn(b, t_q, 3, h, d, generator=g, device="cuda")
        qkv = qkv.to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.randn(b, t_q, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, t_kv, h, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, t_kv, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def attention_bound(b, t_q, t_kv, h, d, causal, dtype):
    """Least time (ms) the card could take for one attention forward, and
    what bounds it: each of q, k, v read once and o, lse written once,
    over the memory rate; the multiply-adds of the live (unmasked) score
    entries, Q K^T and P V, over the dtype's peak."""
    live = sum(min(i + 1, t_kv) for i in range(t_q)) if causal \
        else t_q * t_kv
    flops = 4 * d * live * b * h
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * t_q + 2 * b * t_kv) * h * d * size + b * h * t_q * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, warmup=3, iters=20):
    """Median device time of one call (ms), by CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def environment():
    _phase("environment")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _emit({"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}})
    return card


def build_kernels():
    _phase("build")
    t0 = time.perf_counter()
    build.build_all([fa.LIBRARY])
    print(fa.LIBRARY.build_log, flush=True)
    _emit({"build_s": time.perf_counter() - t0,
           "nvcc_s": {fa.LIBRARY.name: fa.LIBRARY.build_seconds}})


def check_kernels():
    """Hold the kernel against its plain version; returns the largest
    float32 error on O at the serving shapes."""
    _phase("kernel check")
    serving_err = None
    for i, (label, b, t_q, t_kv, h, d, causal, dtype) in enumerate(CHECKS):
        q, k, v = _qkv(b, t_q, t_kv, h, d, dtype, seed=i)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = fa.attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        _emit({"check": label, "shape": [b, t_q, t_kv, h, d],
               "causal": causal, "dtype": str(dtype),
               "max_abs_err": err, "lse_max_abs_err": lse_err})
        torch.testing.assert_close(o.float(), ro.float(), **KERNEL_TOL[dtype])
        torch.testing.assert_close(lse, rlse, **LSE_TOL)
        if label == "serving" and dtype == torch.float32:
            serving_err = err
    return serving_err


def _random_params(symbol, shapes, rng):
    """GPT-2's initialisation scale: N(0, 0.02) weights, embeddings and
    biases; LayerNorm gamma 1 and beta 0."""
    params = {}
    for name, shape in zip(symbol.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith("_beta"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * 0.02
        params[name] = torch.from_numpy(arr)
    return params


def gpt2_small():
    """The served cell: the LM symbol at GPT-2 small's widths, its
    checkpoint (random weights from SEED) written in the reference format
    and loaded onto the card by ``Predictor.from_checkpoint``, and
    REQUESTS batches of token ids.  Returns (symbol, predictor, params
    blob, load seconds, requests)."""
    rng = np.random.default_rng(SEED)
    symbol = mt.models.transformer.get_symbol(**GPT2_SMALL)
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    shapes, _, _ = symbol.infer_shape(data=(BATCH, t),
                                      softmax_label=(BATCH, t))
    params = _random_params(symbol, shapes, rng)
    requests = [rng.integers(0, vocab, (BATCH, t)) for _ in range(REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt2-small")
        symbol.save(prefix + "-symbol.json")
        mt.nd.save(prefix + "-0000.params",
                   {"arg:" + k: v for k, v in params.items()})
        del params
        t0 = time.perf_counter()
        pred = mt.Predictor.from_checkpoint(prefix, 0, {"data": (BATCH, t)})
        load_s = time.perf_counter() - t0
        with open(prefix + "-0000.params", "rb") as f:
            blob = f.read()
    if pred.device.type != "cuda":
        raise AssertionError("Predictor chose %s, not the card" % pred.device)
    return symbol, pred, blob, load_s, requests


def serve():
    """Serve REQUESTS requests through the Predictor on the card; returns
    the kernel launch counts and the request latencies (s)."""
    _phase("serve")
    symbol, pred, blob, load_s, requests = gpt2_small()
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]

    fa.flash_attention_fwd.launches = 0
    latencies, first = [], None
    for ids in requests:
        before = fa.flash_attention_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (probs,) = pred.predict(data=ids)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        per_forward = fa.flash_attention_fwd.launches - before
        if per_forward != GPT2_SMALL["num_layers"]:
            raise AssertionError("flash attention ran %d times in one "
                                 "forward, expected %d"
                                 % (per_forward, GPT2_SMALL["num_layers"]))
        if probs.shape != (BATCH * t, vocab) or probs.device.type != "cuda":
            raise AssertionError("output %s on %s" % (tuple(probs.shape),
                                                      probs.device))
        if not torch.isfinite(probs).all():
            raise AssertionError("non-finite probabilities")
        torch.testing.assert_close(probs.sum(-1),
                                   torch.ones_like(probs[:, 0]),
                                   rtol=0, atol=1e-4)
        first = probs if first is None else first
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches}
    _emit({"serve": "gpt2-small", "batch": BATCH, "seq_len": t,
           "requests": REQUESTS, "load_s": load_s,
           "latency_s": latencies, "launches": launches})

    # logits, not near-uniform probabilities, carry the comparison
    head = symbol.get_internals()["head_output"].tojson()
    gpu = mt.Predictor(head, blob, {"data": (BATCH, t)}) \
        .predict(data=requests[0])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = mt.Predictor(head, blob, {"data": (BATCH, t)}, dev_type="cpu") \
        .predict(data=requests[0])[0]
    cpu_s = time.perf_counter() - t0
    gpu = gpu.cpu()
    _emit({"logits_max_abs_err": (gpu - cpu).abs().max().item(),
           "logits_max_abs": cpu.abs().max().item(),
           "bf16_rounding_max_abs_err":
               (cpu.bfloat16().float() - cpu).abs().max().item(),
           "cpu_reference_s": cpu_s})
    torch.testing.assert_close(gpu, cpu, **LOGIT_TOL)
    if torch.allclose(cpu.bfloat16().float(), cpu, **LOGIT_TOL):
        raise AssertionError("the logit tolerance would pass bfloat16")
    torch.testing.assert_close(first.cpu(), torch.softmax(cpu, dim=-1),
                               **PROB_TOL)
    return launches, latencies


def times(latencies):
    """Kernel, plain and library times at the serving shapes; returns
    the float32 kernel record's numbers."""
    _phase("times")
    b, t, h = BATCH, GPT2_SMALL["seq_len"], GPT2_SMALL["num_heads"]
    d = GPT2_SMALL["num_hidden"] // h
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(b, t, t, h, d, dtype, seed=100)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(
            lambda: fa.attention_reference(q, k, v, causal=True))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True))
        bound_ms, bound_by = attention_bound(b, t, t, h, d, True, dtype)
        line = {"kernel": "flash_attention_fwd", "dtype": str(dtype),
                "shape": [b, t, t, h, d], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
        _emit(line)
        if dtype == torch.float32:
            record = line
    steady = statistics.median(latencies[1:])
    _emit({"predictor": "gpt2-small", "batch": BATCH, "seq_len": t,
           "steady_latency_s": steady, "requests_per_s": 1.0 / steady,
           "tokens_per_s": BATCH * t / steady,
           "first_request_s": latencies[0]})
    return record


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    build_kernels()
    serving_err = check_kernels()
    launches, latencies = serve()
    record = times(latencies)
    _emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/op/pallas/flash_attention.py:38",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": serving_err,
        "ms": record["ms"], "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
        "library_ms": record["library_ms"], "dtype": "float32",
        "card": card}]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
