#!/usr/bin/env python3
"""How far apart two correct float32 runs of one ResNet-50 train step
are, on the CPU: the measurement behind the tolerances of
``chip_smoke.py``'s ResNet phases.

Run from the root of a checkout (CPU only; it imports both packages):

    JAX_PLATFORMS=cpu python3 tools/torch_resnet_tolerances.py

At the shapes of ``chip_smoke.py``'s ``train_resnet_vs_cpu`` phase
(ResNet-50 v2, NHWC, ImageNet form, batch 4 of 112 x 112 images, random
weights from a seed: ``chip_smoke.resnet_params_and_batch``) it takes
one training forward and backward through the port's executor and
through the JAX package's, from the same weights, data and labels, then
an eval forward on moving statistics set to that step's batch
statistics, and prints the relative error (norm of the difference over
the norm) of every parameter gradient (and the head's, fc1), every
BatchNorm moving statistic, the step's output and the eval output.  Then,
through the port's fused Trainer, the same step's float32 gradients
under ``compute_dtype="bfloat16"`` against float32 compute, and the
same through the JAX package's Trainer.  And what TF32 would do: the
port's step with its convolutions' operands rounded to TF32, against the
float32 one.  One JSON
object: the largest and the median error of each comparison, and the
worst parameter.
"""
import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jax_models  # noqa: E402
from mxnet_tpu.parallel import Trainer as JaxTrainer  # noqa: E402

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.op import nn as tnn  # noqa: E402
from mxnet_tpu_torch.parallel import Trainer  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _summary(errs):
    worst = max(errs, key=errs.get)
    return {"max": errs[worst], "worst": worst,
            "median": statistics.median(errs.values())}


def step(pkg, symbol, arg, aux, x, y):
    """One training forward and backward through ``pkg``'s executor, then
    an eval forward on moving statistics set to that step's batch
    statistics (as ``chip_smoke._batch_statistics`` sets them): (gradients,
    moving statistics, {step output, eval output})."""
    ctx = pkg.cpu()
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in symbol.list_arguments()}
    exe = symbol.simple_bind(ctx, grad_req=req, data=x.shape,
                             softmax_label=y.shape)
    exe.copy_params_from({n: pkg.nd.array(v, ctx=ctx)
                          for n, v in arg.items()},
                         {n: pkg.nd.array(v, ctx=ctx)
                          for n, v in aux.items()})
    out = exe.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx),
                      softmax_label=pkg.nd.array(y, ctx=ctx))[0].asnumpy()
    exe.backward()
    grads = {n: exe.grad_dict[n].asnumpy() for n in arg}
    moving = {n: exe.aux_dict[n].asnumpy() for n in aux}
    m = chip_smoke.RESNET_BN_MOMENTUM
    stats = {n: ((v.astype(np.float64) - m * aux[n]) / (1 - m))
             .astype(np.float32) for n, v in moving.items()}
    exe.copy_params_from({}, {n: pkg.nd.array(v, ctx=ctx)
                              for n, v in stats.items()})
    evals = exe.forward(is_train=False, data=pkg.nd.array(x, ctx=ctx))[0]
    return grads, moving, {"step_output": out, "eval_output": evals.asnumpy()}


def _tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_step(symbol, arg, aux, x, y):
    """The port's step with every convolution's operands rounded to TF32,
    as cuDNN rounds them where TF32 is allowed: what a convolution that
    failed to turn TF32 off would do to the compared arrays."""
    conv = tnn._ConvolutionFn
    plain = conv.forward

    def rounded(ctx, xs, w, *geom):
        return plain(ctx, _tf32(xs), _tf32(w), *geom)

    conv.forward = staticmethod(rounded)
    try:
        return step(mt, symbol, arg, aux, x, y)
    finally:
        conv.forward = staticmethod(plain)


def trainer_grads(symbol, arg, aux, x, y, compute_dtype):
    """The fused Trainer's float32 gradients of one step, on the CPU."""
    with mt.cpu():
        tr = Trainer(symbol, mt.optimizer.SGD(learning_rate=0.1),
                     compute_dtype=compute_dtype)
    tr.bind({"data": x.shape}, {"softmax_label": y.shape})
    tr.init_params(arg_params={n: torch.from_numpy(v) for n, v in arg.items()},
                   aux_params={n: torch.from_numpy(v) for n, v in aux.items()})
    batch = tr._device_batch({"data": x, "softmax_label": y.astype(np.int32)})
    _, _, grads = tr._run_backward(tr.params, tr.aux, batch, None)
    return {n: g.numpy() for n, g in grads.items()}


def jax_trainer_grads(symbol, arg, aux, x, y, compute_dtype):
    """The JAX package's fused Trainer's gradients of one step, read from
    one SGD step at lr 1 (no momentum, no weight decay): the float32
    master weights move by exactly minus the gradient, but for their own
    rounding."""
    tr = JaxTrainer(symbol, mx.optimizer.SGD(learning_rate=1.0),
                    compute_dtype=compute_dtype)
    tr.bind({"data": x.shape}, {"softmax_label": y.shape})
    tr.init_params(arg_params={n: mx.nd.array(v) for n, v in arg.items()},
                   aux_params={n: mx.nd.array(v) for n, v in aux.items()})
    tr.step({"data": x, "softmax_label": y.astype(np.int32)})
    after, _ = tr.get_params()
    return {n: arg[n] - after[n].asnumpy() for n in arg}


def main():
    kw = chip_smoke.RESNET
    batch, image = chip_smoke.RESNET_CHECK_BATCH, chip_smoke.RESNET_CHECK_IMAGE
    port_sym = mt.models.get_symbol("resnet-50", **kw)
    arg, aux, x, y = chip_smoke.resnet_params_and_batch(port_sym, batch,
                                                        image)
    port = step(mt, port_sym, arg, aux, x, y)
    jax = step(mx, jax_models.get_symbol("resnet-50", **kw), arg, aux, x, y)
    report = {
        "config": {"network": "resnet-50", "layout": "NHWC", "batch": batch,
                   "image": image, "seed": chip_smoke.SEED, "device": "cpu"},
        "port_vs_jax_grad": _summary({n: _rel(port[0][n], jax[0][n])
                                      for n in arg}),
        "port_vs_jax_fc1_grad": {n: _rel(port[0][n], jax[0][n])
                                 for n in ("fc1_weight", "fc1_bias")},
        "port_vs_jax_moving": _summary({n: _rel(port[1][n], jax[1][n])
                                        for n in aux}),
        "port_vs_jax_outputs": {k: _rel(v, jax[2][k])
                                for k, v in port[2].items()},
    }
    tf32 = tf32_step(port_sym, arg, aux, x, y)
    report["tf32_vs_port"] = {
        "grad": _summary({n: _rel(tf32[0][n], port[0][n]) for n in arg}),
        "fc1_grad": {n: _rel(tf32[0][n], port[0][n])
                     for n in ("fc1_weight", "fc1_bias")},
        "moving": _summary({n: _rel(tf32[1][n], port[1][n]) for n in aux}),
        "outputs": {k: _rel(v, port[2][k]) for k, v in tf32[2].items()}}
    del port, jax, tf32
    f32 = trainer_grads(port_sym, arg, aux, x, y, None)
    bf16 = trainer_grads(port_sym, arg, aux, x, y, "bfloat16")
    report["bf16_vs_f32_grad"] = _summary({n: _rel(bf16[n], f32[n])
                                           for n in f32})
    report["bf16_vs_f32_fc1_grad"] = {n: _rel(bf16[n], f32[n])
                                      for n in ("fc1_weight", "fc1_bias")}
    jsym = jax_models.get_symbol("resnet-50", **kw)
    j32 = jax_trainer_grads(jsym, arg, aux, x, y, None)
    j16 = jax_trainer_grads(jsym, arg, aux, x, y, "bfloat16")
    report["jax_bf16_vs_f32_grad"] = _summary({n: _rel(j16[n], j32[n])
                                               for n in j32})
    report["jax_bf16_vs_f32_fc1_grad"] = {n: _rel(j16[n], j32[n])
                                          for n in ("fc1_weight", "fc1_bias")}
    report["port_vs_jax_trainer_f32_grad"] = _summary(
        {n: _rel(f32[n], j32[n]) for n in j32})
    report["port_vs_jax_trainer_bf16_grad"] = _summary(
        {n: _rel(bf16[n], j16[n]) for n in j16})
    print(json.dumps(report))


if __name__ == "__main__":
    main()
