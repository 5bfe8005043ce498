"""Worker processes for the port's data-parallel tests, started by
``tools/launch.py``:

    python tools/launch.py -n 2 --launcher local -- \\
        python tests/torch_dist_workers.py <suite> <outdir>

Importing the port joins the launcher's ``torch.distributed`` group
(gloo on the CPU).  Each rank writes its results as numpy to
``<outdir>/<case>-rank<r>.npz`` (records as JSON, ``.json``); the tests
hold them against the JAX package in their own process.  This file imports only the port.
"""
import json
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


# ----------------------------------------------------------------------
# the integrity vote (tests/test_torch_integrity.py): the MLP of the JAX
# package's tests/test_integrity.py, its global batch of INTEG_BATCH rows
# split over the ranks
INTEG_BATCH = 8


def save_json(out, case, record):
    rank = coll._process_index()
    with open(os.path.join(out, "%s-rank%d.json" % (case, rank)), "w") as f:
        json.dump(record, f)


def integ_mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = sym.Activation(net, name="relu1", act_type="relu")
    net = sym.FullyConnected(net, name="fc2", num_hidden=4)
    return sym.SoftmaxOutput(net, name="softmax")


def integ_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 32).astype("f") * 0.1,
            "fc1_bias": np.zeros(16, "f"),
            "fc2_weight": rng.randn(4, 16).astype("f") * 0.1,
            "fc2_bias": np.zeros(4, "f")}


def integ_batches(n=10, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(INTEG_BATCH, 32).astype("f"),
             rng.randint(0, 4, INTEG_BATCH).astype("f")) for _ in range(n)]


def integ_trainer(**kw):
    """The vote's trainer over a data mesh of every rank, this rank's
    rows of each global batch bound."""
    per = INTEG_BATCH // coll._process_count()
    with mt.cpu():
        t = mt.parallel.Trainer(
            integ_mlp(mt.sym), mt.optimizer.SGD(
                learning_rate=0.1, momentum=0.9,
                rescale_grad=1.0 / INTEG_BATCH),
            mesh=mt.parallel.data_parallel_mesh(), **kw)
        t.bind(data_shapes={"data": (per, 32)},
               label_shapes={"softmax_label": (per,)})
        t.init_params(arg_params={k: mt.nd.array(v)
                                  for k, v in integ_params().items()})
    return t


def integ_feed(t, x, y):
    n, rank = coll._process_count(), coll._process_index()
    per = INTEG_BATCH // n
    rows = slice(rank * per, (rank + 1) * per)
    return t.step({"data": x[rows], "softmax_label": y[rows]})


def integ_run(t, batches):
    """Feed every batch; the IntegrityError's record, or None."""
    try:
        for x, y in batches:
            integ_feed(t, x, y)
    except mt.integrity.IntegrityError as e:
        # a copy: a rollback replay resolves a pending record's blame in
        # place
        return json.loads(json.dumps(e.record))
    return None


def integ_same(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def on_cpu(fn):
    """Run ``fn`` with the CPU as the current context."""
    def run(*args):
        with mt.cpu():
            return fn(*args)
    return run


def integ_replay(flip_step):
    """bitflip on rank 1 at ``flip_step``, vote every 4 updates: the
    detection, then the replay from the start, then the state against a
    run without the fault."""
    mt.faults.configure("bitflip@step=%d:rank=1:leaf=fc1_weight"
                        % flip_step)
    t = integ_trainer(integrity="vote", integrity_period=4)
    blamed = []
    t.on_integrity_blame = blamed.append
    batches = integ_batches()
    rec = integ_run(t, batches)
    divergences = t.integrity_divergences
    fresh = integ_trainer(integrity="vote", integrity_period=4)
    t.set_params({k: mt.nd.array(v) for k, v in integ_params().items()}, {})
    t.set_opt_states(fresh.get_opt_states())
    replay = integ_run(t, batches)
    clean = integ_trainer(integrity="vote", integrity_period=4)
    integ_run(clean, batches)
    mt.faults.clear()
    return {"mode": t._integ_mode, "record": rec, "divergences": divergences,
            "replay_record": replay, "blamed": [b["blamed"] for b in blamed],
            "pending": t._integrity_pending, "bitwise": integ_same(t, clean)}


@on_cpu
def run_integrity_vote(out):
    save_json(out, "vote-replay", integ_replay(7))
    save_json(out, "vote-not-adjacent", integ_replay(5))
    # ZeRO-1: the shards sit out the vote; the record's fingerprints are
    # of whole leaves
    tz = integ_trainer(integrity="vote", integrity_period=3, zero=1)
    integ_run(tz, integ_batches(6))
    named = tz._named_state(whole=True)
    rec = tz.state_fingerprint()
    save(out, "zero1-state", **{p: v.numpy() for p, v in named})
    save_json(out, "zero1", {
        "divergences": tz.integrity_divergences, "record": rec,
        "rep": dict(zip(tz._integ_paths, tz._integ_rep_mask.tolist()))})
    for case, spec, kw in (
            ("zero1-flip", "bitflip@step=7:rank=0:leaf=fc1_weight",
             dict(integrity_period=4, zero=1)),
            ("opt-alias", "bitflip@step=1:rank=1:leaf=opt/fc1_weight",
             dict(integrity_period=2))):
        mt.faults.configure(spec)
        save_json(out, case, {"record": integ_run(
            integ_trainer(integrity="vote", **kw), integ_batches(10))})
        mt.faults.clear()


@on_cpu
def run_integrity_vote4(out):
    mt.faults.configure("bitflip@step=3:rank=2:leaf=fc2_weight:bit=3")
    t = integ_trainer(integrity="vote", integrity_period=2)
    rec = integ_run(t, integ_batches(6))
    mt.faults.clear()
    save_json(out, "vote-majority", {
        "record": rec, "blamed": [b["blamed"] for b in t.integrity_blamed]})


class _StubElastic:
    """A coordinator that only records the quarantines asked of it."""

    def __init__(self):
        self.quarantined = []

    def guard(self, step=None):
        return None

    def quarantine(self, rank):
        self.quarantined.append(int(rank))


def integ_fit(num_epoch, prefix=None, elastic=None):
    """``Module.fit`` of the vote's MLP over a data mesh of every rank
    (the module's context), 5 global batches an epoch, this rank's rows;
    each rank's checkpoints under a prefix of its own."""
    n, rank = coll._process_count(), coll._process_index()
    rng = np.random.RandomState(0)
    x = rng.randn(40, 32).astype("f")
    y = rng.randint(0, 4, 40).astype("f")
    per = INTEG_BATCH // n
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = "always"
    try:
        mt.random.seed(0)
        with mt.cpu():
            it = mt.io.NDArrayIter(rank_rows(x, rank, n, INTEG_BATCH),
                                   rank_rows(y, rank, n, INTEG_BATCH),
                                   batch_size=per, shuffle=False)
            mod = mt.mod.Module(integ_mlp(mt.sym),
                                context=mt.parallel.data_parallel_mesh())
            mod.fit(it, num_epoch=num_epoch,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9,
                                      "rescale_grad": 1.0 / INTEG_BATCH},
                    initializer=mt.init.Xavier(),
                    checkpoint=None if prefix is None
                    else "%s-rank%d" % (prefix, rank),
                    elastic=elastic)
    finally:
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    return mod


@on_cpu
def run_integrity_fit(out):
    os.environ["MXTPU_INTEGRITY_MODE"] = "vote"
    os.environ["MXTPU_INTEGRITY_PERIOD"] = "4"
    clean = integ_fit(3, os.path.join(out, "clean"))
    mt.faults.configure("bitflip@step=7:rank=1:leaf=fc1_weight")
    inj = integ_fit(3, os.path.join(out, "inj"))
    mt.faults.clear()
    tr = inj._trainer
    a, b = clean.get_params()[0], inj.get_params()[0]
    save_json(out, "fit-rollback", {
        "divergences": tr.integrity_divergences,
        "blamed": [r["blamed"] for r in tr.integrity_blamed],
        "bitwise": all(np.array_equal(a[k].asnumpy(), b[k].asnumpy())
                       for k in a)})
    errors = {}
    for case, spec, env in (
            # every update from 7 on flips the same bit again: an odd
            # number of flips between two checks, so each replay
            # diverges again at update 8
            ("cap", "bitflip@step=7:rank=1:leaf=fc1_weight:count=99",
             {"MXTPU_INTEGRITY_MAX_ROLLBACKS": "2"}),
            ("no-ckpt", "bitflip@step=3:rank=1:leaf=fc1_weight", {})):
        mt.faults.configure(spec)
        os.environ.update(env)
        try:
            integ_fit(3 if case == "cap" else 2,
                      os.path.join(out, case) if case == "cap" else None)
            errors[case] = None
        except mt.MXNetError as e:
            errors[case] = str(e)
        for k in env:
            del os.environ[k]
        mt.faults.clear()
    stub = _StubElastic()
    mt.faults.configure("bitflip@step=7:rank=1:leaf=fc1_weight")
    integ_fit(3, os.path.join(out, "q"), elastic=stub)
    mt.faults.clear()
    # a divergence between the last check and a save: refused
    os.environ["MXTPU_INTEGRITY_PERIOD"] = "1000"
    mod = integ_fit(1)
    mgr = mt.resilience.CheckpointManager(
        os.path.join(out, "refuse-rank%d" % coll._process_index()))
    mgr.save(mod, 1)
    first = mgr.latest_verified().epoch
    tr = mod._trainer
    named = dict(tr._named_state())
    mt.integrity.bitflip(named["arg:fc1_weight"], 1, bit=12,
                         my_rank=coll._process_index())
    try:
        mod.state_fingerprint()
        raised = False
    except mt.integrity.IntegrityError:
        raised = True
    mgr.save(mod, 2)
    ck = mgr.verify(2)
    save_json(out, "fit-cases", {
        "errors": errors, "quarantined": stub.quarantined,
        "refuse": {"first_verified": first, "raised": raised,
                   "latest": mgr.latest().epoch,
                   "refused": bool((ck.manifest["integrity"] or {})
                                   .get("refused")),
                   "verifies": mgr.verify_fingerprint(ck),
                   "latest_verified": mgr.latest_verified().epoch}})
    del os.environ["MXTPU_INTEGRITY_MODE"]
    del os.environ["MXTPU_INTEGRITY_PERIOD"]


SUITES = {"n2": (run_lowp, run_trainers, run_conv_bn, run_modules,
                 run_resume, run_store),
          "n4": (run_lowp,),
          "integrity2": (run_integrity_vote, run_integrity_fit),
          "integrity4": (run_integrity_vote4,)}


if __name__ == "__main__":
    suite, outdir = sys.argv[1], sys.argv[2]
    for case in SUITES[suite]:
        case(outdir)
        coll.barrier()
