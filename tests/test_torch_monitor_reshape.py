"""The port's ``Monitor`` (``mxnet_tpu_torch/monitor.py`` and the
executor's per-op tap) and ``reshape`` (``Executor``, the executor
group, ``Module`` on both paths, the fused ``Trainer``) on the CPU,
against the JAX package's (``tests/test_aux.py``,
``tests/test_executor.py``).  The inputs come from a numpy seed."""
import contextlib
import logging

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

# float32 on both sides, sums in another order
REL_TOL = 1e-5


def _net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, name="fc", num_hidden=8)
    net = pkg.sym.Activation(net, name="relu", act_type="relu")
    net = pkg.sym.FullyConnected(net, name="out", num_hidden=4)
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(n=64, d=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, d)).astype("f")
    y = (x @ rng.normal(0, 1, (d, 4))).argmax(1).astype("f")
    return x, y


def _init(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.normal(0, 0.5, (8, 6)).astype("f"),
            "fc_bias": rng.normal(0, 0.1, 8).astype("f"),
            "out_weight": rng.normal(0, 0.5, (4, 8)).astype("f"),
            "out_bias": np.zeros(4, "f")}


@pytest.fixture
def classic(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "never")


def _recorder(pkg):
    """A Monitor that keeps its rows, each statistic as a float."""
    class Recorder(pkg.monitor.Monitor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen = []

        @staticmethod
        def _render(stat):
            return float(stat.asnumpy().reshape(-1)[0])

        def toc(self):
            rows = super().toc()
            self.seen.extend(rows)
            return rows
    return Recorder


def _fit_monitored(pkg, ctx, iter_ctx, mon, init, num_epoch=1):
    x, y = _data()
    with iter_ctx:
        it = pkg.io.NDArrayIter(x, y, batch_size=16)
        mod = pkg.mod.Module(_net(pkg), context=ctx)
        mod.fit(it, num_epoch=num_epoch, monitor=mon,
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: pkg.nd.array(v, ctx=ctx)
                            for k, v in init.items()})
    return mod


@pytest.mark.parametrize("interval,pattern,sort", [
    (1, ".*", False), (2, ".*output.*", True), (3, "fc.*", False)])
def test_monitor_rows_match_the_jax_package(classic, interval, pattern,
                                            sort):
    """``fit(monitor=...)`` over two epochs of four batches: the same rows
    (batch, name) in the same order in both packages, and each statistic
    (the default ``||x||_2 / sqrt(n)``) within REL_TOL of the JAX
    package's."""
    init = _init()
    jmon = _recorder(mx)(interval, pattern=pattern, sort=sort)
    pmon = _recorder(mt)(interval, pattern=pattern, sort=sort)
    _fit_monitored(mx, mx.cpu(), contextlib.nullcontext(), jmon, init,
                   num_epoch=2)
    _fit_monitored(mt, mt.cpu(), mt.cpu(), pmon, init, num_epoch=2)
    assert [r[:2] for r in pmon.seen] == [r[:2] for r in jmon.seen]
    assert pmon.seen
    assert sorted({r[0] for r in pmon.seen}) == \
        [b + 1 for b in range(0, 8, interval)]
    for (_, name, got), (_, _, want) in zip(pmon.seen, jmon.seen):
        assert abs(got - want) <= REL_TOL * max(abs(want), 1e-6), name


def test_monitor_taps_outputs_and_prints_sorted(classic, caplog):
    """``tests/test_aux.py``'s two monitor cases: a tap of every op
    output, and ``toc_print`` sorted by name."""
    x, y = _data()
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, batch_size=16)
        mod = mt.mod.Module(_net(mt))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.init.Xavier())
    seen = mt.monitor.Monitor(1, stat_func=lambda v: v,
                              pattern=".*output.*")
    mod.install_monitor(seen)
    seen.tic()
    mod.forward(next(iter(it)), is_train=True)
    names = {name for _, name, _ in seen.toc()}
    assert names == {"fc_output", "relu_output", "out_output",
                     "softmax_output"}
    mon = mt.monitor.Monitor(1, pattern=".*", sort=True)
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(next(iter(it)), is_train=True)
    with caplog.at_level(logging.INFO):
        mon.toc_print()
    printed = [r.message.split()[2] for r in caplog.records
               if r.message.startswith("Batch:")]
    assert printed == sorted(printed) and len(printed) > 4


def test_a_monitored_step_equals_an_unmonitored_one(classic):
    """The tap takes statistics of values off the autograd graph: the
    outputs and gradients of a monitored step are bitwise an unmonitored
    step's."""
    x, y = _data()
    init = _init()
    runs = []
    for mon in (mt.monitor.Monitor(1), None):
        with mt.cpu():
            it = mt.io.NDArrayIter(x, y, batch_size=16)
            mod = mt.mod.Module(_net(mt))
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                    for k, v in init.items()})
        if mon is not None:
            mod.install_monitor(mon)
            mon.tic()
        mod.forward_backward(next(iter(it)))
        if mon is not None:
            assert mon.toc()
        exe = mod._exec_group.execs[0]
        runs.append([o.asnumpy() for o in mod.get_outputs()] +
                    [exe.grad_dict[n].asnumpy() for n in sorted(init)])
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def test_bucketing_module_monitors_buckets_bound_later(caplog):
    """The monitor reaches the buckets bound at the call and those bound
    after it; on the fused path ``install_monitor`` warns instead."""
    def sym_gen(key):
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=4, name="fc%d" % key)
        return (mt.sym.SoftmaxOutput(net, name="softmax"), ("data",),
                ("softmax_label",))

    with mt.cpu():
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=6)
    mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
    mod.init_params()
    mon = mt.monitor.Monitor(1, pattern=".*output")
    mod.install_monitor(mon)
    for key in (6, 3):
        batch = mt.io.DataBatch(
            [mt.nd.array(np.ones((4, key), "f"), ctx=mt.cpu())],
            [mt.nd.array(np.zeros(4, "f"), ctx=mt.cpu())], bucket_key=key,
            provide_data=[("data", (4, key))],
            provide_label=[("softmax_label", (4,))])
        mon.tic()
        mod.forward(batch, is_train=False)
        assert {name for _, name, _ in mon.toc()} == {
            "fc%d_output" % key, "softmax_output"}
    with mt.cpu():
        fused = mt.mod.Module(_net(mt))
    fused._fused_mode = "always"
    fused.bind([("data", (16, 6))], [("softmax_label", (16,))])
    with caplog.at_level(logging.WARNING):
        fused.install_monitor(mon)
    assert any("no per-op taps" in r.message for r in caplog.records)


# ======================================================================
# reshape
def test_executor_reshape_matches_the_jax_package():
    """``tests/test_executor.py::test_reshape`` in both packages: the
    weights carried over, the new input shape, and the same outputs."""
    outs = []
    for pkg in (mx, mt):
        x = pkg.sym.Variable("x")
        fc = pkg.sym.FullyConnected(x, num_hidden=4, name="fc")
        exe = fc.simple_bind(ctx=pkg.cpu(), x=(2, 3))
        exe.arg_dict["fc_weight"][:] = 1.0
        exe.arg_dict["fc_bias"][:] = 0.5
        new = exe.reshape(x=(5, 3))
        assert new.arg_dict["x"].shape == (5, 3)
        assert new.arg_dict["fc_weight"] is exe.arg_dict["fc_weight"]
        assert np.allclose(new.arg_dict["fc_weight"].asnumpy(), 1.0)
        new.forward(x=np.arange(15, dtype="f").reshape(5, 3))
        outs.append(new.outputs[0].asnumpy())
    assert outs[1].shape == (5, 4)
    np.testing.assert_array_equal(outs[0], outs[1])


def _module(fused, init, batch):
    with mt.cpu():
        mod = mt.mod.Module(_net(mt))
    mod._fused_mode = fused
    mod.bind([("data", (batch, 6))], [("softmax_label", (batch,))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in init.items()})
    # the rescale fixed: a default one follows the bound batch size
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9,
                                         "rescale_grad": 1.0 / 16})
    assert (mod._trainer is not None) == (fused == "always")
    return mod


def _step(mod, x, y):
    with mt.cpu():
        batch = mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    return [o.asnumpy() for o in mod.get_outputs()]


@pytest.mark.parametrize("fused", ["never", "always"])
def test_module_reshape_steps_as_a_fresh_module(tmp_path, fused):
    """Two steps at batch 16, ``reshape`` to batch 8, two steps, back to
    16, one step: each step after a reshape is bitwise a fresh module's
    at that shape with the same parameters and optimizer state; the
    fused Trainer keeps one state and a signature per shape."""
    x, y = _data()
    mod = _module(fused, _init(), 16)
    for i in range(2):
        _step(mod, x[16 * i:16 * i + 16], y[16 * i:16 * i + 16])
    for batch, rows in ((8, [(32, 40), (40, 48)]), (16, [(48, 64)])):
        arg, aux = mod.get_params()
        states = str(tmp_path / "s")
        mod.save_optimizer_states(states)
        fresh = _module(fused, {k: v.asnumpy() for k, v in arg.items()},
                        batch)
        fresh.load_optimizer_states(states)
        if fused == "always":
            params = mod._trainer.params
        mod.reshape([("data", (batch, 6))], [("softmax_label", (batch,))])
        assert mod.data_shapes[0].shape == (batch, 6)
        if fused == "always":
            assert mod._trainer.params is params
        for a, b in rows:
            got = _step(mod, x[a:b], y[a:b])
            want = _step(fresh, x[a:b], y[a:b])
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            for k, v in fresh.get_params()[0].items():
                assert np.array_equal(mod.get_params()[0][k].asnumpy(),
                                      v.asnumpy()), k
    if fused == "always":
        assert mod._trainer.num_update == 5
        with pytest.raises(mt.MXNetError, match="fc_weight"):
            mod._trainer.reshape({"data": (16, 7)},
                                 {"softmax_label": (16,)})
        assert mod._trainer._input_shapes["data"] == (16, 6)


def test_module_reshape_matches_the_jax_package(classic):
    """The classic ``Module.reshape`` of both packages from the same
    weights: the same outputs at the new batch size."""
    x, _ = _data()
    init = _init()
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        mod = pkg.mod.Module(_net(pkg), context=ctx)
        mod.bind([("data", (16, 6))], [("softmax_label", (16,))],
                 for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in init.items()})
        mod.reshape([("data", (5, 6))], [("softmax_label", (5,))])
        batch = pkg.io.DataBatch([pkg.nd.array(x[:5], ctx=ctx)], None)
        mod.forward(batch, is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (5, 4)
    np.testing.assert_allclose(outs[1], outs[0], rtol=REL_TOL, atol=1e-7)
