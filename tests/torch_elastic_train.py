#!/usr/bin/env python
"""The port's elastic shrink-and-resume drill, run by the elastic
launcher with a whole-host death injected::

    MXTPU_FAULTS="host_dead@step=11:rank=1" \\
        python tools/launch.py --local-elastic 2 -- \\
        python tests/torch_elastic_train.py <workdir> [--model mlp|gpt2]

Round 1: the workers train data-parallel through ``Module.fit(kvstore=
"dist_sync", elastic=...)`` (ZeRO-1 and the bfloat16 gradient wire, as
the JAX package's drill sets them), with the coordinator's guard before
every step; every rank checkpoints each epoch (a ZeRO-1 states blob
gathers whole leaves, a collective), rank 0 into the shared line
``<workdir>/ckpt``.  The targeted rank dies at its step-N guard, before
committing to the step barrier, so no survivor enters a collective
without it; the survivor's guard finds the lapsed heartbeat, publishes
the shrunk membership epoch and exits with ``SHRINK_EXIT_CODE``.
Round 2: the launcher starts the shrunk world, which joins a group of
one, resumes from the newest intact checkpoint of the shared line and
trains to the end, writing the resumed-first-step wall clock the
launcher turns into ``ELASTIC_RECOVERY_S``.

``--replay E``: the parity reference, one process without a launcher
resuming from checkpoint epoch E of the same workdir and training the
same remaining epochs; it waits for that checkpoint, so it may start
beside the elastic run.  Its final parameters must be bitwise the
elastic run's.

``--model mlp`` (the default) is the JAX drill's MLP on the CPU;
``--model gpt2`` is GPT-2 small in bfloat16 on the card (the fused step
through the attention kernels, at 2 layers: its widths, not its
depth), with fewer, shorter epochs and a longer
heartbeat timeout (a checkpoint's save of a GB or two holds the
interpreter lock in stalls that a heartbeat thread starved past a short
timeout cannot tell from death: at 12 layers a 4 s timeout once failed).  Each process writes ``record-<round>-rank<r>.json``:
its kernel launches and the longest the interpreter lock kept a thread
waking every 50 ms waiting past its time; the final parameters' digests
go to ``final.json`` (``replay-final.json``) and, for the MLP, the
arrays to ``final.npz`` (``replay-final.npz``).
"""
import argparse
import hashlib
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

# the MLP drill: the JAX drill's (tests/nightly/elastic_train.py)
LOCAL_BATCH = 16
N_ROWS = 128
TOTAL_EPOCHS = 4
# the GPT-2 drill: GPT-2 small's widths at 2 layers (the checkpoint is
# then mostly the 38.6 M-parameter embedding), 2 epochs of 2 steps of 2
# rows a rank before the shrink, then one rank
GPT2 = dict(seq_len=1024, num_hidden=768, num_heads=12, num_layers=2,
            vocab_size=50257)
GPT2_ROWS, GPT2_STEPS, GPT2_EPOCHS = 2, 2, 3
# how long a replay waits for the checkpoint it starts from
REPLAY_WAIT_S = 600


def _net(mt, model):
    if model == "gpt2":
        return mt.models.transformer.get_symbol(**GPT2)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=32,
                                name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def _data(model):
    """The rows every rank draws from (the same on every rank): the
    MLP's 128 rows, or counting token sequences for GPT-2."""
    if model == "gpt2":
        rng = np.random.default_rng(7)
        t, vocab = GPT2["seq_len"], GPT2["vocab_size"]
        n = GPT2_ROWS * GPT2_STEPS * 2
        seqs = (rng.integers(0, vocab, n)[:, None] + np.arange(t + 1)) % vocab
        return seqs[:, :t].astype(np.int32), seqs[:, 1:].astype(np.int32)
    rng = np.random.RandomState(7)
    x = rng.normal(0, 1, (N_ROWS, 16)).astype("f")
    y = (x @ rng.normal(0, 1, (16, 4))).argmax(1).astype("f")
    return x, y


def _fit_args(model, global_batch):
    if model == "gpt2":
        return dict(optimizer="adam",
                    optimizer_params={"learning_rate": 3e-4,
                                      "rescale_grad": 1.0 / global_batch})
    return dict(optimizer="sgd",
                optimizer_params={"learning_rate": 0.2,
                                  "rescale_grad": 1.0 / global_batch})


def _module(mt, model):
    ctx = mt.gpu() if model == "gpt2" else mt.cpu()
    return mt.mod.Module(_net(mt, model), context=ctx,
                         compute_dtype="bfloat16" if model == "gpt2"
                         else None)


def _iter(mt, model, x, y, local):
    if model == "gpt2":
        return mt.io.NDArrayIter(x, y, batch_size=local, shuffle=False)
    with mt.cpu():
        return mt.io.NDArrayIter(x, y, batch_size=local, shuffle=False)


def _save_final(mod, model, workdir, replay=False):
    arg, _ = mod.get_params()
    host = {k: v.asnumpy() for k, v in arg.items()}
    tag = "replay-final" if replay else "final"
    digest = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
              .hexdigest() for k, v in host.items()}
    with open(os.path.join(workdir, tag + ".json"), "w") as f:
        json.dump(digest, f)
    if model == "mlp":
        np.savez(os.path.join(workdir, tag + ".npz"), **host)


def _stall_probe():
    """A thread that wakes every 50 ms; returns a list whose one value is
    the longest it has waited past its time (the interpreter lock held
    elsewhere: what starves the heartbeat thread too)."""
    worst = [0.0]

    def run():
        while True:
            t0 = time.monotonic()
            time.sleep(0.05)
            worst[0] = max(worst[0], time.monotonic() - t0 - 0.05)

    threading.Thread(target=run, daemon=True).start()
    return worst


def _save_record(workdir, tag, rank, stall):
    """The attention kernels' launches this process counted, and its
    longest stall."""
    from mxnet_tpu_torch.op.kernels import flash_attention as fa
    with open(os.path.join(workdir, "record-%s-rank%d.json"
                           % (tag, rank)), "w") as f:
        json.dump({"launches": {**fa.flash_attention_fwd.kernel_launches,
                                **fa.flash_attention_bwd.kernel_launches},
                   "max_stall_s": stall[0]}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--model", choices=("mlp", "gpt2"), default="mlp")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--replay", type=int, default=None, metavar="EPOCH",
                    help="parity reference: one process without a "
                    "launcher resumed from checkpoint EPOCH, which it "
                    "waits for (it may start beside the run it checks)")
    args = ap.parse_args()
    epochs = args.epochs or (GPT2_EPOCHS if args.model == "gpt2"
                             else TOTAL_EPOCHS)

    # tight drill timings (each still the caller's to set)
    os.environ.setdefault("MXTPU_ELASTIC_HB_TIMEOUT_S",
                          "10" if args.model == "gpt2" else "4")
    os.environ.setdefault("MXTPU_ELASTIC_STEP_TIMEOUT_S", "12")
    os.environ.setdefault("MXTPU_ELASTIC_CHECK_S", "0.5")
    os.environ.setdefault("MXTPU_MODULE_FUSED", "always")

    stall = _stall_probe()
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import elastic, resilience
    from mxnet_tpu_torch.parallel import collectives as coll

    if args.model == "gpt2":
        # float32 products as the card's other phases run them
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.workdir, exist_ok=True)
    prefix = os.path.join(args.workdir, "ckpt")
    mgr = resilience.CheckpointManager(prefix, keep=50)
    local = GPT2_ROWS if args.model == "gpt2" else LOCAL_BATCH
    mt.random.seed(0)

    if args.replay is not None:
        # the manifest is committed last, by a rename
        deadline = time.monotonic() + REPLAY_WAIT_S
        while not os.path.exists(mgr._manifest_path(args.replay)):
            if time.monotonic() > deadline:
                raise SystemExit("no checkpoint at epoch %d after %d s"
                                 % (args.replay, REPLAY_WAIT_S))
            time.sleep(0.2)
        ck = mgr.verify(args.replay)
        assert ck is not None, "no intact checkpoint at epoch %d" \
            % args.replay
        _, arg_params, aux_params = ck.load_params()
        x, y = _data(args.model)
        mod = _module(mt, args.model)
        if ck.states_path:
            mod._preload_opt_states = ck.states_path
        mod.fit(_iter(mt, args.model, x, y, local), num_epoch=epochs,
                begin_epoch=ck.epoch, kvstore="local",
                arg_params=arg_params, aux_params=aux_params,
                allow_missing=False, initializer=None,
                **_fit_args(args.model, local))
        _save_final(mod, args.model, args.workdir, replay=True)
        _save_record(args.workdir, "replay", 0, stall)
        print("torch_elastic_train: replay from epoch %d done" % ck.epoch,
              flush=True)
        return 0

    rank, nworker = coll._process_index(), coll._process_count()
    coord = elastic.ElasticCoordinator(rank=rank, num_workers=nworker)
    if nworker > 1:
        os.environ.setdefault("MXTPU_ZERO", "1")
        os.environ.setdefault("MXTPU_GRAD_DTYPE", "bf16")
    x, y = _data(args.model)
    xs, ys = x[rank::nworker], y[rank::nworker]

    begin = 0
    arg_params = aux_params = None
    ck = mgr.latest()
    mod = _module(mt, args.model)
    if ck is not None:
        _, arg_params, aux_params = ck.load_params()
        begin = ck.epoch
        if ck.states_path:
            mod._preload_opt_states = ck.states_path
        print("worker %d/%d: auto-resume from checkpoint epoch %d "
              "(step %s)" % (rank, nworker, begin, ck.step), flush=True)
        if rank == 0:
            with open(os.path.join(args.workdir, "resume-info.json"),
                      "w") as f:
                json.dump({"resumed_epoch": begin, "world": nworker}, f)

    stamped = []

    def _first_step_cb(param):
        # the resumed first step's wall clock: the "recovered" end of
        # ELASTIC_RECOVERY_S, read by the launcher from the elastic dir
        if ck is None or stamped or rank != 0:
            return
        stamped.append(time.time())
        edir = os.environ.get("MXTPU_ELASTIC_DIR")
        if edir:
            with open(os.path.join(edir, "resume-status.json"), "w") as f:
                json.dump({"first_step_wall": stamped[0],
                           "resumed_epoch": begin, "world": nworker}, f)

    # every rank saves (a ZeRO-1 blob is gathered from every rank); rank
    # 0's saves are the shared line the relaunched world resumes from
    line = mgr if rank == 0 else resilience.CheckpointManager(
        "%s-rank%d" % (prefix, rank), keep=2)
    try:
        mod.fit(_iter(mt, args.model, xs, ys, local), num_epoch=epochs,
                begin_epoch=begin, kvstore="dist_sync",
                arg_params=arg_params, aux_params=aux_params,
                allow_missing=False,
                initializer=mt.init.Xavier(rnd_type="gaussian",
                                           magnitude=2.0),
                checkpoint=line, checkpoint_period=1,
                batch_end_callback=_first_step_cb, elastic=coord,
                **_fit_args(args.model, local * nworker))
    except elastic.ElasticShrink as e:
        revoked = isinstance(e, elastic.ElasticRevoked)
        print("worker %d/%d: %s — %s" % (
            rank, nworker,
            "revoked (declared dead); exiting cleanly" if revoked
            else "membership shrank; exiting for relaunch", e),
            flush=True)
        _save_record(args.workdir, "world%d" % nworker, rank, stall)
        coord.close()
        sys.stdout.flush()
        sys.stderr.flush()
        # os._exit: the process group's teardown would wait on the dead
        # peer; the world this process belonged to no longer exists
        os._exit(elastic.SHRINK_EXIT_CODE)

    _save_record(args.workdir, "world%d" % nworker, rank, stall)
    if rank == 0:
        _save_final(mod, args.model, args.workdir)
    coord.close()
    print("worker %d/%d: elastic train done (resumed from %s)"
          % (rank, nworker, begin if ck is not None else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
