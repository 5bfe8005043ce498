"""Worker processes for the port's data-parallel tests, started by
``tools/launch.py``:

    python tools/launch.py -n 2 --launcher local -- \\
        python tests/torch_dist_workers.py <suite> <outdir>

Importing the port joins the launcher's ``torch.distributed`` group
(gloo on the CPU).  Each rank writes its results as numpy to
``<outdir>/<case>-rank<r>.npz``; the tests hold them against the JAX
package in their own process.  This file imports only the port.
"""
import os
import pickle
import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import collectives as coll

# the MLP every case trains: its global batch, in rows split over ranks
MLP_IN, MLP_HIDDEN, MLP_OUT = 10, 16, 4
GLOBAL_BATCH = 8
STEPS = 3
SEED = 7


def mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=MLP_HIDDEN, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=MLP_OUT, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def mlp_params(seed=SEED):
    """The MLP's starting weights, the same on every rank and in the
    tests."""
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (MLP_HIDDEN, MLP_IN), "fc1_bias": (MLP_HIDDEN,),
              "fc2_weight": (MLP_OUT, MLP_HIDDEN), "fc2_bias": (MLP_OUT,)}
    return {k: rng.normal(0, 0.3, s).astype("f") for k, s in shapes.items()}


def mlp_batches(steps=STEPS, seed=SEED):
    """``steps`` global batches: ``(x, y)`` of GLOBAL_BATCH rows each."""
    rng = np.random.RandomState(seed + 1)
    x = rng.normal(0, 1, (steps * GLOBAL_BATCH, MLP_IN)).astype("f")
    y = rng.randint(0, MLP_OUT, steps * GLOBAL_BATCH).astype("f")
    return x, y


def rank_rows(a, rank, n, batch=GLOBAL_BATCH):
    """Rank ``rank``'s rows of every global batch of ``a``, in order."""
    per = batch // n
    idx = [s * batch + rank * per + i for s in range(len(a) // batch)
           for i in range(per)]
    return a[idx]


def conv_bn(sym):
    """A convolution, BatchNorm and a head."""
    data = sym.Variable("data")
    net = sym.Convolution(data, num_filter=8, kernel=(3, 3), layout="NHWC",
                          name="c1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=MLP_OUT, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


CONV_IN = (6, 6, 3)


def conv_bn_params(sym, seed=SEED):
    shapes, _, _ = conv_bn(sym).infer_shape(data=(2,) + CONV_IN)
    rng = np.random.RandomState(seed)
    names = conv_bn(sym).list_arguments()
    return {n: (np.ones(s) if n.endswith("_gamma")
                else rng.normal(0, 0.3, s)).astype("f")
            for n, s in zip(names, shapes)
            if n not in ("data", "softmax_label")}


def conv_bn_batches(steps=STEPS, seed=SEED):
    rng = np.random.RandomState(seed + 2)
    x = rng.normal(0, 1, (steps * GLOBAL_BATCH,) + CONV_IN).astype("f")
    y = rng.randint(0, MLP_OUT, steps * GLOBAL_BATCH).astype("f")
    return x, y


def lowp_inputs(rank, n):
    """Per-rank gradients: leaves whose dim 0 divides by n, and not."""
    rng = np.random.RandomState(100 + rank)
    shapes = [(8, 3), (4 * n, 2), (3, 5), (7,), ()]
    return [rng.normal(0, 1, s).astype("f") for s in shapes]


def save(out, case, **arrays):
    rank = coll._process_index()
    np.savez(os.path.join(out, "%s-rank%d.npz" % (case, rank)), **arrays)


def run_lowp(out):
    n, rank = coll._process_count(), coll._process_index()
    res = {}
    for i, x in enumerate(lowp_inputs(rank, n)):
        t = torch.from_numpy(x)
        for keep in (False, True):
            res["leaf%d_keep%d" % (i, keep)] = coll.lowp_allreduce(
                t, "data", n, torch.bfloat16, keep_shard=keep).numpy()
    save(out, "lowp", **res)


def trainer_run(zero, grad_dtype, optimizer="sgd", steps=STEPS):
    """The fused Trainer over a data mesh of every rank: this rank's rows
    of each global batch, ``steps`` steps."""
    n, rank = coll._process_count(), coll._process_index()
    with mt.cpu():
        opt = mt.optimizer.create(
            optimizer, learning_rate=0.1, rescale_grad=1.0 / GLOBAL_BATCH,
            **({"momentum": 0.9} if optimizer == "sgd" else {}))
        tr = mt.parallel.Trainer(mlp(mt.sym), opt,
                                 mesh=mt.parallel.data_parallel_mesh(),
                                 zero=zero, grad_dtype=grad_dtype)
        per = GLOBAL_BATCH // n
        tr.bind(data_shapes={"data": (per, MLP_IN)},
                label_shapes={"softmax_label": (per,)})
        tr.init_params(arg_params=mlp_params())
        x, y = mlp_batches(steps)
        xs, ys = rank_rows(x, rank, n), rank_rows(y, rank, n)
        outs = []
        for s in range(steps):
            outs.append(tr.step({"data": xs[s * per:(s + 1) * per],
                                 "softmax_label": ys[s * per:(s + 1) * per]}
                                )[0].asnumpy())
    return tr, np.concatenate(outs)


def run_conv_bn(out):
    """The conv/BatchNorm net over the data mesh: with the float32 wire
    BatchNorm normalises by the whole global batch, as the JAX package's
    step over its mesh does; with the bfloat16 wire by each rank's rows,
    as its shard_map'd backward does."""
    n, rank = coll._process_count(), coll._process_index()
    per = GLOBAL_BATCH // n
    x, y = conv_bn_batches()
    xs, ys = rank_rows(x, rank, n), rank_rows(y, rank, n)
    for case, kw in (("conv-bn", {"grad_dtype": "bf16"}),
                     ("conv-bn-f32", {}), ("conv-bn-f32-z1", {"zero": 1}),
                     ("conv-bn-f32-legacy", {"dtype_policy": "legacy"}),
                     ("conv-bn-f32-remat", {"remat": "nothing"})):
        with mt.cpu():
            tr = mt.parallel.Trainer(
                conv_bn(mt.sym), mt.optimizer.create(
                    "sgd", learning_rate=0.1, momentum=0.9,
                    rescale_grad=1.0 / GLOBAL_BATCH),
                mesh=mt.parallel.data_parallel_mesh(), **kw)
            tr.bind(data_shapes={"data": (per,) + CONV_IN},
                    label_shapes={"softmax_label": (per,)})
            tr.init_params(arg_params=conv_bn_params(mt.sym))
            for s in range(STEPS):
                tr.step({"data": xs[s * per:(s + 1) * per],
                         "softmax_label": ys[s * per:(s + 1) * per]})
        save(out, case, **{k: v.numpy() for k, v in
                           list(tr.params.items()) + list(tr.aux.items())})


def run_trainers(out):
    blobs = {}
    for zero in (0, 1):
        for wire in ("f32", "bf16"):
            for optimizer in ("sgd", "adam"):
                tr, outs = trainer_run(zero, wire, optimizer)
                blob = tr.get_opt_states()
                blobs[(zero, wire, optimizer)] = blob
                arrays = {"p_" + k: v.numpy() for k, v in tr.params.items()}
                save(out, "trainer-z%d-%s-%s" % (zero, wire, optimizer),
                     outputs=outs, state_bytes=tr.opt_state_bytes_per_chip(),
                     comm_bytes=tr.grad_comm_bytes_per_step(),
                     blob=np.frombuffer(blob, np.uint8), **arrays)
    # a zero=0 blob restored onto a zero=1 trainer, and the reverse: the
    # whole leaves come back
    for src, dst in ((0, 1), (1, 0)):
        tr, _ = trainer_run(dst, "f32", "adam", steps=1)
        tr.set_opt_states(blobs[(src, "f32", "adam")])
        _, state, _, _ = pickle.loads(tr.get_opt_states())
        _, want, _, _ = pickle.loads(blobs[(src, "f32", "adam")])
        same = all(torch.equal(a, b) for m in want
                   for a, b in zip(want[m], state[m]))
        tr.step({"data": np.zeros((GLOBAL_BATCH // coll._process_count(),
                                   MLP_IN), "f"),
                 "softmax_label": np.zeros(
                     GLOBAL_BATCH // coll._process_count(), "f")})
        save(out, "blob-%dto%d" % (src, dst), same=same)


def module_fit(fused, num_epoch=2, checkpoint=None, resume=False,
               context=None):
    """``Module.fit`` with a ``dist_sync`` store on this rank's rows."""
    n, rank = coll._process_count(), coll._process_index()
    if fused is not None:
        os.environ["MXTPU_MODULE_FUSED"] = "always" if fused else "never"
    x, y = mlp_batches()
    per = GLOBAL_BATCH // n
    with mt.cpu():
        it = mt.io.NDArrayIter(rank_rows(x, rank, n), rank_rows(y, rank, n),
                               batch_size=per)
        mod = mt.mod.Module(mlp(mt.sym), context=context)
        mod.fit(it, num_epoch=num_epoch, kvstore="dist_sync",
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: mt.nd.array(v)
                            for k, v in mlp_params().items()},
                checkpoint=checkpoint, resume=resume)
    return mod


def run_modules(out):
    for fused in (False, True):
        mod = module_fit(fused)
        arg, _ = mod.get_params()
        save(out, "module-%s" % ("fused" if fused else "classic"),
             fused=mod._trainer is not None,
             **{k: v.asnumpy() for k, v in arg.items()})
    # a mesh as the context, fused by default: the step over its ranks
    os.environ.pop("MXTPU_MODULE_FUSED", None)
    mod = module_fit(None, context=mt.parallel.data_parallel_mesh())
    arg, _ = mod.get_params()
    save(out, "module-mesh", fused=mod._trainer is not None,
         **{k: v.asnumpy() for k, v in arg.items()})


def run_resume(out):
    """zero=1 on the fused path: 3 epochs straight, and 2 epochs then a
    resumed run to 3, each rank with checkpoints of its own."""
    os.environ["MXTPU_ZERO"] = "1"
    rank = coll._process_index()
    straight = module_fit(True, num_epoch=3)
    prefix = os.path.join(out, "ckpt-rank%d" % rank)
    module_fit(True, num_epoch=2, checkpoint=prefix)
    resumed = module_fit(True, num_epoch=3, checkpoint=prefix, resume=True)
    a, _ = straight.get_params()
    b, _ = resumed.get_params()
    save(out, "resume", zero_on=resumed._trainer._zero_on,
         same=all(np.array_equal(a[k].asnumpy(), b[k].asnumpy())
                  for k in a),
         **{k: b[k].asnumpy() for k in b})
    del os.environ["MXTPU_ZERO"]


def run_store(out):
    """The dist store: rank 0's init wins, a push sums over the ranks,
    the store's heartbeats see every rank alive."""
    rank = coll._process_index()
    kv = mt.kvstore.create("dist_sync")
    with mt.cpu():
        kv.init("w", mt.nd.array(np.full((3,), 10.0 + rank, "f")))
        got = mt.nd.zeros((3,))
        kv.pull("w", out=got)
        kv.push("w", [mt.nd.array(np.full((3,), rank + 1.0, "f")),
                      mt.nd.array(np.ones((3,), "f"))])
        summed = mt.nd.zeros((3,))
        kv.pull("w", out=summed)
    kv._barrier()
    from mxnet_tpu_torch import health
    kv_stamps = health._kv_stamps(health._kv_client(), kv.num_workers)
    save(out, "store", init=got.asnumpy(), summed=summed.asnumpy(),
         rank=kv.rank, workers=kv.num_workers,
         dead=kv.num_dead_node(timeout=60), kv_ranks=sorted(kv_stamps))


SUITES = {"n2": (run_lowp, run_trainers, run_conv_bn, run_modules,
                 run_resume, run_store),
          "n4": (run_lowp,)}


if __name__ == "__main__":
    suite, outdir = sys.argv[1], sys.argv[2]
    for case in SUITES[suite]:
        case(outdir)
        coll.barrier()
