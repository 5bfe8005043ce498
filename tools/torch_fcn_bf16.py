#!/usr/bin/env python3
"""Whether FCN-8s's loss falls under bfloat16 compute in the JAX package
as in this port: the check behind ``chip_smoke.py``'s train_fcn, which
gates a falling loss in float32 and reports the bfloat16 one.

Run from the root of a checkout (CPU only; it imports both packages):

    JAX_PLATFORMS=cpu python3 tools/torch_fcn_bf16.py \\
        [--lrs 1e-10,1e-9] [--dtypes bfloat16,float32] [--image 64]

FCN-8s at VGG-16's full widths (``chip_smoke.fcn8s_symbol``, Dropout at
p = 0) on one ``chip_smoke.fcn_batch`` of 1 x 3 x image^2 (border 4),
the weights from the port's Mixed(Bilinear, Xavier) initializer
(``chip_smoke.fcn_initializer``) from seed 0, given to both packages.
Each package's Module on its fused path (a Trainer step, float32 master
weights, ``compute_dtype`` for the products), SGD with fcn_xs.py's
momentum 0.99 and wd 5e-4, 8 steps on the same batch.  One JSON line a
(lr, dtype, package): the cross entropy of each step's forward over the
pixels not labelled 255.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

STEPS = 8


def initial_weights(shape):
    with mt.cpu(), mt.name.NameManager():
        mt.random.seed(0)
        mod = mt.mod.Module(chip_smoke.fcn8s_symbol(mt.sym, dropout=0.0),
                            context=mt.cpu())
        mod.bind([("data", shape)], [("softmax_label", shape[:1] + shape[2:])])
        mod.init_params(chip_smoke.fcn_initializer())
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def cross_entropy(probs, y):
    pick = np.take_along_axis(
        probs.astype(np.float64),
        np.minimum(y, chip_smoke.FCN_CLASSES - 1)[:, None], 1)[:, 0]
    valid = y != chip_smoke.FCN_IGNORE
    return float(-np.log(np.maximum(pick, 1e-30))[valid].mean())


def fit(pkg, weights, x, y, lr, compute_dtype):
    with pkg.cpu(), pkg.name.NameManager():
        mod = pkg.mod.Module(chip_smoke.fcn8s_symbol(pkg.sym, dropout=0.0),
                             context=pkg.cpu(), compute_dtype=compute_dtype)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in weights.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            chip_smoke.FCN_SGD, learning_rate=lr))
        assert mod._trainer is not None, "not the fused path"
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x)],
                                 label=[pkg.nd.array(y.astype(np.float32))],
                                 pad=0)
        curve = []
        for _ in range(STEPS):
            mod.forward(batch, is_train=True)
            mod.update()
            curve.append(cross_entropy(mod.get_outputs()[0].asnumpy(), y))
    return curve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1e-10")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--image", type=int, default=64)
    args = ap.parse_args()
    os.environ["MXTPU_MODULE_FUSED"] = "always"
    shape = (1, 3, args.image, args.image)
    x, y = chip_smoke.fcn_batch(shape, border=4)
    weights = initial_weights(shape)
    for lr in (float(v) for v in args.lrs.split(",")):
        for dtype in args.dtypes.split(","):
            for name, pkg in (("mxnet_tpu_torch", mt), ("mxnet_tpu", mx)):
                t0 = time.perf_counter()
                curve = fit(pkg, weights, x, y, lr,
                            None if dtype == "float32" else dtype)
                print(json.dumps({
                    "package": name, "lr": lr, "compute_dtype": dtype,
                    "image": args.image, "cross_entropy_by_step": curve,
                    "fell": curve[-1] < curve[0],
                    "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
