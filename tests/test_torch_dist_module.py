"""The port's several-context classic path and worker health, in one
process on the CPU, against the JAX package: ``_split_input_slice`` and
``decide_slices``, ``Module`` over ``[cpu(0), cpu(1)]`` beside the JAX
``Module`` over the same contexts, and heartbeat stamps each package
writes read by the other's ``dead_nodes``."""
import re
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import executor_manager as jem
from mxnet_tpu import health as jhealth

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor_manager as tem
from mxnet_tpu_torch import health as thealth

# float32 sums in another order (executor by executor, then the store)
REL_TOL = 1e-5


@pytest.mark.parametrize("batch,work", [
    (8, [1, 1]), (10, [1, 1, 1]), (7, [2, 1]), (32, [1, 2, 3, 4]),
    (5, [1, 1, 1, 1, 1]), (3, [1, 1, 1, 1])])
def test_split_input_slice_is_the_jax_one(batch, work):
    try:
        want = jem._split_input_slice(batch, work)
    except mx.MXNetError as e:
        with pytest.raises(mt.MXNetError, match="Too many slices"):
            tem._split_input_slice(batch, work)
        assert "Too many slices" in str(e)
        return
    assert tem._split_input_slice(batch, work) == want


def _mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("work", [None, [1, 3]])
def test_decide_slices_and_executor_shapes(work):
    """One executor per context, each bound to its slice of the batch as
    the JAX package's group binds it."""
    from mxnet_tpu.module.executor_group import DataParallelExecutorGroup \
        as JGroup
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup as TGroup
    shapes = [mt.io.DataDesc("data", (8, 10))]
    labels = [mt.io.DataDesc("softmax_label", (8,))]
    params = ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    j = JGroup(_mlp(mx.sym), [mx.cpu(0), mx.cpu(1)], work,
               [mx.io.DataDesc("data", (8, 10))],
               [mx.io.DataDesc("softmax_label", (8,))], params, True, False)
    t = TGroup(_mlp(mt.sym), [mt.cpu(0), mt.cpu(1)], shapes, labels, params,
               True, False, workload=work)
    assert t.slices == j.slices
    assert [e.arg_dict["data"].shape for e in t.execs] == \
        [tuple(e.arg_dict["data"].shape) for e in j.execs]
    assert len(t.param_arrays[0]) == 2 and len(t.grad_arrays[0]) == 2


def _fit(pkg, contexts, kvstore, epochs=2):
    rng = np.random.RandomState(4)
    x = rng.randn(48, 10).astype("f")
    y = rng.randint(0, 4, 48).astype("f")
    wr = np.random.RandomState(9)
    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (4, 16), "fc2_bias": (4,)}
    arg = {k: pkg.nd.array(wr.normal(0, 0.3, s).astype("f"))
           for k, s in shapes.items()}
    it = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod = pkg.mod.Module(_mlp(pkg.sym), context=contexts)
    mod.fit(it, num_epoch=epochs, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=arg)
    out, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in out.items()}


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_module_over_two_contexts_matches_the_jax_module(monkeypatch,
                                                         kvstore):
    """The classic path over ``[cpu(0), cpu(1)]``: each executor on half
    of every batch, the gradients merged through the store; the
    parameters end within 1e-5 of the JAX Module over the same contexts
    and of the port's own single context."""
    monkeypatch.delenv("MXTPU_MODULE_FUSED", raising=False)
    with mt.cpu():
        mod, got = _fit(mt, [mt.cpu(0), mt.cpu(1)], kvstore)
        _, one = _fit(mt, [mt.cpu(0)], kvstore)
    assert mod._trainer is None and len(mod._exec_group.execs) == 2
    assert mod._kvstore is not None
    _, want = _fit(mx, [mx.cpu(0), mx.cpu(1)], kvstore)
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel < REL_TOL, (k, rel)
        rel = np.linalg.norm(got[k] - one[k]) / np.linalg.norm(one[k])
        assert rel < REL_TOL, (k, rel)


@pytest.mark.parametrize("writer,reader", [(jhealth, thealth),
                                           (thealth, jhealth)])
def test_heartbeat_stamps_read_across_packages(tmp_path, writer, reader):
    """A stamp directory one package writes, the other's ``dead_nodes``
    reads (the same ``hb-<rank>`` files, ``"<time> <seq>"``)."""
    reader._reset_seq_cache()
    beats = [writer.Heartbeat(r, directory=str(tmp_path), interval=0.05)
             for r in range(2)]
    time.sleep(0.15)
    assert reader.dead_nodes(2, timeout=1.0, directory=str(tmp_path)) == []
    assert reader.dead_nodes(3, timeout=1.0,
                             directory=str(tmp_path)) == [2]
    beats[1].stop()
    deadline = time.time() + 10.0
    while time.time() < deadline and reader.dead_nodes(
            2, timeout=0.3, directory=str(tmp_path)) != [1]:
        time.sleep(0.1)
    assert reader.dead_nodes(2, timeout=0.3,
                             directory=str(tmp_path)) == [1]
    beats[0].stop()
    wall, seq = reader._parse_stamp((tmp_path / "hb-0").read_text())
    assert wall is not None and seq >= 1


def test_heartbeat_is_inert_without_a_transport(monkeypatch):
    monkeypatch.delenv("MXTPU_HEARTBEAT_DIR", raising=False)
    h = thealth.Heartbeat(0)
    assert not h.active
    assert thealth.dead_nodes(4, timeout=0.1) == []
    h.stop()
    assert mt.kvstore.create("dist_sync").num_dead_node() == 0


def test_dead_nodes_tolerates_torn_stamps(tmp_path):
    (tmp_path / "hb-0").write_text("garbage\x00")
    (tmp_path / "hb-1").write_text("")
    (tmp_path / "hb-2").mkdir()
    assert thealth.dead_nodes(3, timeout=30.0,
                              directory=str(tmp_path)) == []


def test_two_contexts_keep_lr_mult_and_wd_defaults(monkeypatch):
    """A local updater keys device k's copy of parameter i as
    ``i * 2 + k``; the optimizer names those keys, so an lr_mult and the
    bias/gamma weight decay default apply to every copy, and two
    contexts train as one does (ROADMAP §C; before, device 1's copies
    took the next parameter's multipliers)."""
    monkeypatch.delenv("MXTPU_MODULE_FUSED", raising=False)
    rng = np.random.RandomState(4)
    x = rng.randn(32, 10).astype("f")
    y = rng.randint(0, 4, 32).astype("f")
    data = mt.sym.Variable("data")
    w = mt.sym.Variable("fc1_weight", lr_mult=0.25)
    net = mt.sym.FullyConnected(data, weight=w, num_hidden=16, name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
    sym = mt.sym.SoftmaxOutput(net, name="softmax")
    wr = np.random.RandomState(9)
    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (4, 16), "fc2_bias": (4,)}
    init = {k: wr.normal(0, 0.3, s).astype("f") for k, s in shapes.items()}
    got = {}
    with mt.cpu():
        for contexts in ([mt.cpu(0)], [mt.cpu(0), mt.cpu(1)]):
            mod = mt.mod.Module(sym, context=contexts)
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                    kvstore="local", optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5, "wd": 0.1},
                    arg_params={k: mt.nd.array(v) for k, v in init.items()})
            arg, _ = mod.get_params()
            got[len(contexts)] = {k: v.asnumpy() for k, v in arg.items()}
    for k in shapes:
        rel = np.linalg.norm(got[2][k] - got[1][k]) / np.linalg.norm(got[1][k])
        assert rel < REL_TOL, (k, rel)


@pytest.mark.parametrize("layout,rank,want", [
    # the CPU; one rank on one card; two ranks sharing it
    ([("a", 0)] * 2, 1, ("gloo", None)), ([("a", 1)], 0, ("nccl", "cuda:0")),
    ([("a", 1)] * 2, 1, ("gloo", "cuda:0")),
    # a host of four cards, four ranks and eight
    ([("a", 4)] * 4, 3, ("nccl", "cuda:3")),
    ([("a", 4)] * 8, 5, ("gloo", "cuda:1")),
    # ssh launches: a rank on each of four one-card hosts; two hosts of
    # eight cards, eight ranks each; a crowded host makes all of gloo
    ([(h, 1) for h in "abcd"], 2, ("nccl", "cuda:0")),
    ([("a", 8)] * 8 + [("b", 8)] * 8, 9, ("nccl", "cuda:1")),
    ([("a", 1), ("b", 1), ("b", 1)], 0, ("gloo", "cuda:0")),
    ([("a", 1), ("b", 0)], 0, ("gloo", "cuda:0"))])
def test_the_backend_rule(layout, rank, want):
    """NCCL where each rank has a card of its own, gloo on the CPU and
    where ranks share a card, decided from every rank's host and card
    count; a rank's card is its index among its host's ranks modulo the
    host's cards."""
    from mxnet_tpu_torch.parallel import collectives as coll
    name, device = coll._choose_backend(layout, rank)
    assert (name, None if device is None else str(device)) == want


@pytest.mark.parametrize("env,match", [
    ({"MXTPU_COORDINATOR": "127.0.0.1:1"}, "requires all three"),
    ({"MXTPU_NUM_PROCESSES": "2", "MXTPU_PROCESS_ID": "0",
      "MXTPU_INIT_TIMEOUT_S": "1", "MXTPU_INIT_ATTEMPTS": "2"},
     "[Tt]imed out|DistStoreError")])
def test_a_join_that_cannot_start_raises(tmp_path, env, match):
    """Importing the port under the launcher's variables joins the group:
    a missing variable raises, and a group whose peer never comes raises
    after ``MXTPU_INIT_ATTEMPTS`` attempts of ``MXTPU_INIT_TIMEOUT_S``
    (nothing carries on alone)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    if "MXTPU_COORDINATOR" not in env:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            env = dict(env, MXTPU_COORDINATOR="127.0.0.1:%d"
                       % s.getsockname()[1])
    run = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch"],
        env=dict(os.environ, PYTHONPATH=str(root), **env), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert re.search(match, run.stderr), run.stderr[-2000:]


def test_executor_manager_helpers_follow_the_jax_ones():
    """``_check_arguments`` passes a symbol without duplicated names;
    ``_load_data``/``_load_label`` copy each slice of a batch into its
    target, as the JAX package's do."""
    tem._check_arguments(_mlp(mt.sym))
    jem._check_arguments(_mlp(mx.sym))
    rng = np.random.RandomState(2)
    x = rng.randn(6, 3).astype("f")
    y = np.arange(6).astype("f")
    got = {}
    for pkg, em, ctx in ((mt, tem, mt.cpu()), (mx, jem, mx.cpu())):
        targets = [[(slice(0, 2), pkg.nd.zeros((2, 3), ctx)),
                    (slice(2, 6), pkg.nd.zeros((4, 3), ctx))]]
        labels = [[(slice(0, 2), pkg.nd.zeros((2,), ctx)),
                   (slice(2, 6), pkg.nd.zeros((4,), ctx))]]
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx)],
                                 label=[pkg.nd.array(y, ctx)])
        em._load_data(batch, targets)
        em._load_label(batch, labels)
        got[pkg] = [a.asnumpy() for _, a in targets[0] + labels[0]]
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][1], x[2:6])
