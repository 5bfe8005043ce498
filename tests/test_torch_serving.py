"""The port's serving layer (``mxnet_tpu_torch/serving/``) on the CPU:
the cases of ``tests/test_serving.py`` on the port's ``ModelServer``
(the same tiny MLPs, buckets ``[1, 2, 4, 8]``), the serving forward's
eval-mode stream, and the port against ``mxnet_tpu.serving.ModelServer``
on the same symbols, weights and seeded requests."""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jax_transformer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.compiled import CompiledForward
from mxnet_tpu_torch.serving.server import ServeError, ServeTimeout

# A padded row against the same row's unpadded forward: torch's CPU
# x @ w.T rounds a row differently at another batch size (a convolution
# does not), so padding parity holds to rounding, not bitwise.  Measured
# once over every bucket up to 32 and every fill of this file's MLP:
# 2.09e-7 apart at most (3.8e-6 relative, on the smallest
# probabilities); a wrong row or a shifted slice is off by 1e-2 or more.
PAD_TOL = dict(rtol=1e-5, atol=1e-6)
# the port's float32 outputs against the JAX package's, the same
# weights: products and sums in another order (the tiny LM's logits as
# tests/test_torch_predictor.py holds them)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 softmax outputs of the two packages: both round the
# product to bfloat16 (one ulp is 2^-8 relative) before the softmax
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
TINY_LM = dict(seq_len=16, num_hidden=32, num_heads=4, num_layers=2,
               vocab_size=50)


@pytest.fixture(autouse=True)
def _fresh_cache():
    """The compiled-forward cache is process-wide and keyed on the
    symbol digest: two tests building the same tiny MLP would share one
    trace log."""
    serving.clear_cache()
    yield
    serving.clear_cache()


def _close(a, b):
    """A request served at bucket size B against its exact-shape
    forward: agreement to rounding (PAD_TOL)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **PAD_TOL)


def _mlp_weights(din, hidden, nclass, seed):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(hidden, din).astype("f"),
            "fc1_bias": rng.randn(hidden).astype("f"),
            "fc2_weight": rng.randn(nclass, hidden).astype("f"),
            "fc2_bias": rng.randn(nclass).astype("f")}


def _mlp_symbol(pkg, hidden, nclass, name):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=nclass, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name=name)


def _mlp(din=8, hidden=16, nclass=4, name="softmax", seed=0):
    args = {k: torch.from_numpy(v)
            for k, v in _mlp_weights(din, hidden, nclass, seed).items()}
    return _mlp_symbol(mt, hidden, nclass, name), args, (din,)


def _server(sym, args, example, **kw):
    kw.setdefault("buckets", [1, 2, 4, 8])
    kw.setdefault("max_wait_us", 1000)
    srv = serving.ModelServer(ctx=mt.cpu(), **kw)
    srv.add_model("m", sym, args, {}, input_shapes={"data": example})
    return srv


def _reference(srv, x, model="m", label="softmax_label"):
    """Per-request UNPADDED forward through a FRESH CompiledForward (same
    weights, exact shape, not the server's cached instance — its traces
    must not pollute the server's retrace accounting)."""
    m = srv._models[model]
    cf = CompiledForward(m.symbol, list(m.example_shapes)
                         + list(m.label_trailing))
    x = torch.as_tensor(x)
    feed = {"data": x.to(m.input_dtypes["data"]),
            label: torch.zeros((x.shape[0],), dtype=m.input_dtypes[label])}
    return list(cf.run(m.params, m.aux, feed))


def _x(example, n=1, seed=0):
    return np.random.RandomState(seed).randn(n, *example).astype("f")


# ----------------------------------------------------------------------
def test_eval_forward_draws_the_same_stream_every_call(tmp_path):
    """The serving forward is deterministic by contract, as the JAX
    package's constant key makes it: a forward that draws gets the same
    stream on every call, through CompiledForward.run, Predictor.predict
    and a ModelServer (each request alone in its batch)."""
    data = mt.sym.Variable("data")
    probe = data + mt.sym.random_uniform(shape=(2, 3))
    zeros = torch.zeros(2, 3)
    cf = CompiledForward(probe, ["data"])
    first = cf.run({}, {}, {"data": zeros})[0].clone()
    second = cf.run({}, {}, {"data": zeros})[0]
    assert torch.equal(first, second)
    assert first.std() > 0

    mt.nd.save(str(tmp_path / "none.params"), {"arg:unused": zeros})
    pred = mt.Predictor(probe.tojson(),
                        (tmp_path / "none.params").read_bytes(),
                        {"data": (2, 3)}, dev_type="cpu")
    a = pred.predict(data=zeros)[0].clone()
    assert torch.equal(a, pred.predict(data=zeros)[0])

    row = mt.sym.broadcast_add(data, mt.sym.random_uniform(shape=(1, 3)))
    srv = serving.ModelServer(buckets=[1], max_wait_us=0, ctx=mt.cpu())
    srv.add_model("probe", row, {}, {}, input_shapes={"data": (3,)})
    with srv:
        x = np.zeros((1, 3), np.float32)
        one = srv.predict(data=x)[0]
        two = srv.predict(data=x)[0]
        assert srv.stats()["batches"] == 2
    assert torch.equal(one, two)


def test_padding_parity_every_bucket():
    """Padded-bucket outputs match the per-request unpadded forward for
    every bucket size, full and part-filled (PAD_TOL)."""
    sym, args, example = _mlp()
    with _server(sym, args, example) as srv:
        for bucket in srv.buckets:
            for n in {bucket, max(1, bucket - 1)}:
                x = np.random.RandomState(bucket * 10 + n) \
                    .randn(n, *example).astype("f")
                got = srv.predict(data=x)
                ref = _reference(srv, x)
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert isinstance(g, torch.Tensor) and g.device.type \
                        == "cpu" and g.dtype == r.dtype
                    _close(g, r)
        srv.assert_no_retrace()


def test_coalesced_batch_parity_and_occupancy():
    """Concurrent requests coalesce into ONE padded batch; each future
    gets exactly its own rows back."""
    sym, args, example = _mlp()
    with _server(sym, args, example, max_wait_us=150_000) as srv:
        xs = [np.random.RandomState(i).randn(i + 1, *example).astype("f")
              for i in range(3)]                       # rows 1 + 2 + 3 = 6
        futs = [srv.submit(data=x) for x in xs]
        outs = [f.result(20) for f in futs]
        st = srv.stats()
        assert st["batches"] == 1
        assert st["occupancy"] == {"8": {"batches": 1,
                                         "mean_fill": 0.75}}
        for x, o in zip(xs, outs):
            _close(o[0], _reference(srv, x)[0])
        srv.assert_no_retrace()


def test_held_result_keeps_only_its_own_rows():
    """Each request's result lies in a host block of its own: a 1-row
    result from a coalesced batch of 6 rows (bucket 8) keeps its one row
    alive, not the batch's."""
    sym, args, example = _mlp()
    with _server(sym, args, example, max_wait_us=150_000) as srv:
        xs = [_x(example, n, seed=n) for n in (1, 2, 3)]
        outs = [f.result(20) for f in [srv.submit(data=x) for x in xs]]
        assert srv.stats()["batches"] == 1
    for x, (o,) in zip(xs, outs):
        assert o.shape == (len(x), 4)
        assert o.untyped_storage().nbytes() == o.numel() * o.element_size()
        _close(o, _reference(srv, x)[0])


def test_dropped_server_and_predictor_are_collected(tmp_path):
    """Nothing process-wide keeps a server or a Predictor (nor, on the
    card, the graphs they captured) once its caller drops it: the
    shared compiled forward holds the signatures, not the owners."""
    import gc
    import weakref
    sym, args, example = _mlp()
    srv = _server(sym, args, example)
    with srv:
        srv.predict(data=_x(example))
    pred = mt.Predictor.from_checkpoint(_checkpoint(tmp_path), 1,
                                        {"data": (2, 8)}, dev_type="cpu")
    pred.predict(data=_x((8,), 2))
    refs = [weakref.ref(srv), weakref.ref(pred),
            weakref.ref(pred._params["fc_weight"])]
    del srv, pred
    gc.collect()
    assert [r() for r in refs] == [None, None, None]
    assert serving.cache_stats()["entries"] == 2


def test_mixed_shape_load_zero_retrace():
    """A threaded mixed-shape load keeps the retrace count at zero."""
    sym, args, example = _mlp()
    with _server(sym, args, example) as srv:
        aot = srv.stats()["aot_compiles"]
        results = {}

        def client(cid):
            r = np.random.RandomState(cid)
            for j in range(6):
                n = int(r.randint(1, 5))
                x = r.randn(n, *example).astype("f")
                results[(cid, j)] = (x, srv.predict(data=x))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        st = srv.stats()
        assert st["completed"] == 24 and st["failed"] == 0
        assert st["aot_compiles"] == aot == 4
        assert st["retraces"] == 0 and st["graph_captures"] == 0
        srv.assert_no_retrace()
        for x, out in results.values():
            _close(out[0], _reference(srv, x)[0])


def test_oversized_request_falls_back_and_counts():
    """A request larger than the biggest bucket still completes (exact-
    shape fallback) but is COUNTED as a retrace; ``lint()`` waits for
    the port's static analyses and raises."""
    sym, args, example = _mlp()
    with _server(sym, args, example, buckets=[1, 2, 4]) as srv:
        x = np.random.RandomState(3).randn(6, *example).astype("f")
        out = srv.predict(data=x)
        np.testing.assert_array_equal(out[0], _reference(srv, x)[0])
        st = srv.stats()
        assert st["retraces"] == 1
        with pytest.raises(MXNetError, match="off-bucket.*\\[6\\]"):
            srv.assert_no_retrace()
        with pytest.raises(MXNetError, match="static analyses"):
            srv.lint()


def test_poison_request_fails_alone():
    """Error isolation: the poisoned request's future fails; the other
    requests IN THE SAME BATCH complete with correct values."""
    sym, args, example = _mlp()
    with _server(sym, args, example, max_wait_us=150_000) as srv:
        xs = [np.random.RandomState(i).randn(1, *example).astype("f")
              for i in range(3)]
        with faults.injected("poison_request@request=2"):
            futs = [srv.submit(data=x) for x in xs]
            excs = [f.exception(timeout=20) for f in futs]
        assert excs[0] is None and excs[2] is None
        assert isinstance(excs[1], ServeError)
        assert "batch was unaffected" in str(excs[1])
        st = srv.stats()
        assert st["batches"] == 1
        assert st["completed"] == 2 and st["failed"] == 1
        for i in (0, 2):
            out = futs[i].result()
            assert torch.isfinite(out[0]).all()
            _close(out[0], _reference(srv, xs[i])[0])


def test_slow_request_stretches_only_its_cycle(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_SLOW_S", "0.05")
    sym, args, example = _mlp()
    with _server(sym, args, example) as srv:
        with faults.injected("slow_request@request=1"):
            t0 = time.perf_counter()
            srv.submit(data=np.zeros(example, "f")).result(20)
            slow_lat = time.perf_counter() - t0
            srv.submit(data=np.zeros(example, "f")).result(20)
            assert faults.fired("slow_request") == 1
        assert slow_lat >= 0.05
        assert srv.stats()["failed"] == 0


def test_request_timeout_fails_before_dispatch():
    sym, args, example = _mlp()
    with _server(sym, args, example, max_wait_us=2_000_000,
                 cap=64, timeout_ms=40) as srv:
        exc = srv.submit(data=np.zeros(example, "f")).exception(timeout=20)
        assert isinstance(exc, ServeTimeout)
        st = srv.stats()
        assert st["timeouts"] == 1 and st["batches"] == 0


def test_multi_tenant_two_symbols_one_server():
    sym_a, args_a, ex_a = _mlp(din=8, hidden=16, nclass=4, seed=0)
    sym_b, args_b, ex_b = _mlp(din=5, hidden=12, nclass=3, name="out",
                               seed=1)
    srv = serving.ModelServer(buckets=[1, 2, 4], max_wait_us=1000,
                              ctx=mt.cpu())
    srv.add_model("a", sym_a, args_a, {}, input_shapes={"data": ex_a})
    srv.add_model("b", sym_b, args_b, {}, input_shapes={"data": ex_b})
    with srv:
        with pytest.raises(MXNetError, match="multi-tenant"):
            srv.submit(data=np.zeros(ex_a, "f"))
        xa = np.random.RandomState(0).randn(2, *ex_a).astype("f")
        xb = np.random.RandomState(1).randn(3, *ex_b).astype("f")
        fa = srv.submit(data=xa, model="a")
        fb = srv.submit(data=xb, model="b")
        oa, ob = fa.result(20), fb.result(20)
        assert oa[0].shape == (2, 4) and ob[0].shape == (3, 3)
        _close(oa[0], _reference(srv, xa, model="a")[0])
        _close(ob[0], _reference(srv, xb, model="b", label="out_label")[0])
        srv.assert_no_retrace()


def test_submit_validation_errors():
    sym, args, example = _mlp()
    srv = _server(sym, args, example)
    with pytest.raises(MXNetError, match="not started"):
        srv.submit(data=np.zeros(example, "f"))
    with srv:
        with pytest.raises(MXNetError, match="matches neither"):
            srv.submit(data=np.zeros((3,), "f"))
        with pytest.raises(MXNetError, match="missing input"):
            srv.submit(other=np.zeros(example, "f"))
        with pytest.raises(MXNetError, match="unknown model"):
            srv.submit(data=np.zeros(example, "f"), model="nope")
        with pytest.raises(MXNetError, match="add_model before start"):
            srv.add_model("late", sym, args, {},
                          input_shapes={"data": example})


# ----------------------------------------------------------------------
def _checkpoint(tmp_path, dtype="float32"):
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=5,
                                name="fc")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    dt = mt.base._dtype(dtype)
    args = {"fc_weight": mt.nd.array(rng.normal(0, 1, (5, 8)).astype("f"),
                                     ctx=mt.cpu(), dtype=dt),
            "fc_bias": mt.nd.array(rng.normal(0, 1, (5,)).astype("f"),
                                   ctx=mt.cpu(), dtype=dt)}
    prefix = str(tmp_path / ("m_" + dtype))
    mt.model.save_checkpoint(prefix, 1, net, args, {})
    return prefix


def test_compiled_forward_cache_shared_across_predictors(tmp_path):
    """from_checkpoint of an already-loaded model registers NOTHING new:
    the keyed cache hands both predictors the same CompiledForward."""
    prefix = _checkpoint(tmp_path)
    p1 = mt.Predictor.from_checkpoint(prefix, 1, {"data": (2, 8)},
                                      dev_type="cpu")
    x = np.random.RandomState(1).randn(2, 8).astype("f")
    out1 = p1.predict(data=x)[0]
    traces = serving.cache_stats()["traces"]
    p2 = mt.Predictor.from_checkpoint(prefix, 1, {"data": (2, 8)},
                                      dev_type="cpu")
    assert p2._cf is p1._cf
    assert serving.cache_stats()["traces"] == traces == 1
    assert p1._cf.retraces == 0
    np.testing.assert_array_equal(out1, p2.predict(data=x)[0])


def test_predictor_honors_bound_dtype(tmp_path):
    """A bf16 checkpoint binds bf16 inputs and returns bf16 outputs."""
    prefix = _checkpoint(tmp_path, dtype="bfloat16")
    p = mt.Predictor.from_checkpoint(prefix, 1, {"data": (2, 8)},
                                     dev_type="cpu")
    assert p.input_dtype("data") == torch.bfloat16
    x = np.random.RandomState(1).randn(2, 8).astype("f")
    p.set_input("data", x)
    assert p._inputs["data"].dtype == torch.bfloat16
    p.forward()
    out = p.get_output(0)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().sum(1).numpy(), [1.0, 1.0],
                               rtol=2e-2)
    p32 = mt.Predictor.from_checkpoint(_checkpoint(tmp_path), 1,
                                       {"data": (2, 8)}, dev_type="cpu")
    assert p32.input_dtype("data") == torch.float32
    assert p32.predict(data=x)[0].dtype == torch.float32


def _bf16_fc():
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=5,
                                name="fc")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    return net, {"fc_weight": torch.from_numpy(rng.randn(5, 8).astype("f"))
                 .bfloat16(), "fc_bias": torch.zeros(5).bfloat16()}


def test_server_serves_bf16_model_in_bf16():
    """The serving path inherits the inferred dtype: a bf16 model's
    buckets stage and return bf16, and error isolation holds for it."""
    net, args = _bf16_fc()
    srv = serving.ModelServer(buckets=[1, 2], max_wait_us=1000,
                              ctx=mt.cpu())
    srv.add_model("m", net, args, {}, input_shapes={"data": (8,)})
    with srv:
        assert srv._models["m"].input_dtypes["data"] == torch.bfloat16
        rng = np.random.RandomState(0)
        out = srv.predict(data=rng.randn(8).astype("f"))
        assert out[0].dtype == torch.bfloat16
        bad = np.full((8,), np.nan, np.float32)
        exc = srv.submit(data=bad).exception(timeout=20)
        assert isinstance(exc, ServeError)
        srv.assert_no_retrace()


def test_multi_tenant_shared_symbol_no_double_count():
    """Two checkpoints of ONE architecture share a CompiledForward;
    retrace/AOT accounting counts it once, not per tenant."""
    sym_a, args_a, example = _mlp(seed=0)
    _, args_b, _ = _mlp(seed=9)
    srv = serving.ModelServer(buckets=[1, 2, 4], max_wait_us=1000,
                              ctx=mt.cpu())
    srv.add_model("a", sym_a, args_a, {}, input_shapes={"data": example})
    srv.add_model("b", sym_a, args_b, {}, input_shapes={"data": example})
    assert srv._models["a"].cf is srv._models["b"].cf
    with srv:
        assert srv.stats()["aot_compiles"] == 3      # once, not twice
        x = np.random.RandomState(0).randn(6, *example).astype("f")
        srv.predict(data=x, model="a")               # oversized: 1 retrace
        assert srv.stats()["retraces"] == 1
        with pytest.raises(MXNetError, match="a\\+b"):
            srv.assert_no_retrace()                  # one finding, joined
        oa = srv.predict(data=x[:2], model="a")
        ob = srv.predict(data=x[:2], model="b")
        assert not torch.equal(oa[0], ob[0])


@pytest.mark.parametrize("case", ["indivisible_buckets", "sharded_serving"])
def test_mesh_raises(case):
    """The JAX package's mesh cases (row-sharded buckets) wait for the
    port's mesh slice: ``mesh=`` raises, naming it."""
    kw = {"buckets": [1, 4, 8]} if case == "indivisible_buckets" \
        else {"buckets": [2, 4, 8], "max_wait_us": 1000}
    with pytest.raises(MXNetError, match="mesh"):
        serving.ModelServer(mesh=object(), ctx=mt.cpu(), **kw)


def test_submit_during_start_is_refused(monkeypatch):
    """A client that submits while start() registers the buckets (on
    the card: captures them) is refused with "server not started" until
    start() returns, and then served."""
    sym, args, example = _mlp()
    srv = _server(sym, args, example)
    real = CompiledForward.aot_compile

    def slow(self, *a, **kw):
        time.sleep(0.05)
        return real(self, *a, **kw)

    monkeypatch.setattr(CompiledForward, "aot_compile", slow)
    seen = {"refused": 0, "served": 0}

    def client():
        while not seen["served"]:
            try:
                srv.submit(data=np.zeros(example, "f")).result(20)
                seen["served"] += 1
            except MXNetError as err:
                assert "not started" in str(err)
                seen["refused"] += 1
                time.sleep(0.005)

    t = threading.Thread(target=client)
    t.start()
    try:
        time.sleep(0.02)
        srv.start()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        srv.stop()
    assert seen["refused"] > 0 and seen["served"] == 1


def test_submit_after_stop_raises():
    sym, args, example = _mlp()
    srv = _server(sym, args, example)
    srv.start()
    srv.stop()
    with pytest.raises(MXNetError, match="not started"):
        srv.submit(data=np.zeros(example, "f"))


def test_options_of_later_slices_raise(monkeypatch):
    """Tune plans and the static analyses raise, each naming its slice;
    the int8 tier refuses an unquantized symbol, and the other precision
    tiers admit it."""
    with pytest.raises(MXNetError, match="tuneplan"):
        serving.ModelServer(plan={}, ctx=mt.cpu())
    sym, args, example = _mlp()
    with pytest.raises(MXNetError, match="not quantized"):
        _server(sym, args, example, precision="int8")
    for tier in ("auto", "float32", "bfloat16"):
        srv = _server(sym, args, example, precision=tier)
        assert srv.stats()["per_model"]["m"]["quant"] == "none"
        assert srv.stats()["per_model"]["m"]["predicted_peak_bytes"] == 0
    monkeypatch.setenv("MXTPU_TUNE_PLAN", "plan.json")
    with pytest.raises(MXNetError, match="tuneplan"):
        serving.ModelServer(ctx=mt.cpu())


def test_mem_budget_gates_on_weight_bytes():
    """predicted_peak_bytes is 0, so the budget admits tenants by their
    weight bytes (the JAX package's fallback)."""
    sym, args, example = _mlp()       # 212 float32 weights: 848 bytes
    srv = serving.ModelServer(buckets=[1, 2], mem_budget=1200,
                              ctx=mt.cpu())
    srv.add_model("a", sym, args, {}, input_shapes={"data": example})
    assert srv.stats()["per_model"]["a"]["weight_bytes_on_device"] == 848
    with pytest.raises(MXNetError, match="memory budget"):
        srv.add_model("b", sym, args, {}, input_shapes={"data": example})


def test_instrumented_serving_clean():
    """The serving half of tests/test_concurrency.py's
    test_instrumented_serving_and_upload_clean: a real ModelServer
    driven under a scoped recorder, whose snapshot the JAX package's
    lockset analysis finds ZERO errors in."""
    from mxnet_tpu import analysis
    from mxnet_tpu_torch import _tsan

    with _tsan.scoped() as rec:
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=8, name="cfc1")
        sym = mt.sym.SoftmaxOutput(net, name="softmax")
        rng = np.random.RandomState(0)
        args = {"cfc1_weight": torch.from_numpy(rng.randn(8, 6).astype("f")),
                "cfc1_bias": torch.zeros(8)}
        srv = serving.ModelServer(buckets=[1, 2], max_wait_us=500,
                                  ctx=mt.cpu())
        srv.add_model("m", sym, args, {}, input_shapes={"data": (6,)})
        with srv:
            futs = [srv.submit(data=np.zeros((6,), "f")) for _ in range(8)]
            for f in futs:
                f.result(timeout=30)
            srv.stats()
            srv.load_report()
        snap = rec.snapshot()
    assert "serving.ModelServer.queue" in snap["states"]
    assert "serving.CompiledForward.latency" in snap["states"]
    report = analysis.lint_runtime(snap)
    assert report.errors() == [], report.summary()


# ----------------------------------------------------------------------
# the port against mxnet_tpu.serving.ModelServer
def _tiny_lm(pkg, transformer):
    with pkg.name.NameManager():
        lm = transformer.get_symbol(**TINY_LM)
    t, vocab = TINY_LM["seq_len"], TINY_LM["vocab_size"]
    return pkg.sym.Reshape(lm.get_internals()["head_output"],
                           shape=(-1, t, vocab))


def _tenants():
    """(name, numpy weights, per-example shape, request maker, output
    tolerance) of the three tenants both servers host."""
    rng = np.random.RandomState(5)
    lm = _tiny_lm(mx, jax_transformer)
    shapes, _, _ = lm.infer_shape(data=(2, TINY_LM["seq_len"]))
    lm_w = {n: rng.normal(0, 0.2, s).astype("f")
            for n, s in zip(lm.list_arguments(), shapes) if n != "data"}
    bf = {"fc_weight": rng.randn(5, 8).astype("f"),
          "fc_bias": rng.randn(5).astype("f")}
    return [
        ("mlp", _mlp_weights(8, 16, 4, 0), (8,),
         lambda r, n: r.randn(n, 8).astype("f"), F32_TOL),
        ("lm", lm_w, (TINY_LM["seq_len"],),
         lambda r, n: r.randint(0, TINY_LM["vocab_size"],
                                (n, TINY_LM["seq_len"])), LOGIT_TOL),
        ("bf16", bf, (8,), lambda r, n: r.randn(n, 8).astype("f"),
         BF16_TOL),
    ]


def _symbols(pkg):
    from mxnet_tpu_torch.models import transformer as torch_transformer
    lm = _tiny_lm(pkg, jax_transformer if pkg is mx else torch_transformer)
    fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=5,
                                name="fc")
    return {"mlp": _mlp_symbol(pkg, 16, 4, "softmax"), "lm": lm,
            "bf16": pkg.sym.SoftmaxOutput(fc, name="softmax")}


# one cap-sized window of 8 rows, then 3 rows that wait out the window:
# two batches per tenant (buckets 8 and 4) in both packages
BURSTS = ([1, 2, 1, 3, 1], [2, 1])


def _serve_bursts(srv, tenants):
    outs = {}
    for name, _, example, make, _ in tenants:
        r = np.random.RandomState(17)
        for b, rows in enumerate(BURSTS):
            reqs = [make(r, n) for n in rows]
            futs = [srv.submit({"data": x}, model=name) for x in reqs]
            outs[name, b] = [f.result(30)[0] for f in futs]
    return outs


def test_server_matches_jax_server():
    """The same symbols, weights and seeded requests through both
    servers on the CPU: per-request outputs within each tenant's stated
    tolerance, and the same batching (a deterministic burst: one
    cap-sized window, then a part-filled one)."""
    tenants = _tenants()
    jsyms, tsyms = _symbols(mx), _symbols(mt)
    jsrv = jserving.ModelServer(buckets=[1, 2, 4, 8], max_wait_us=150_000)
    tsrv = serving.ModelServer(buckets=[1, 2, 4, 8], max_wait_us=150_000,
                               ctx=mt.cpu())
    for name, w, example, _, _ in tenants:
        jw = {k: mx.nd.array(v) for k, v in w.items()}
        tw, _ = mt.convert.params_from_mxnet_tpu(
            {k: a.asnumpy() for k, a in jw.items()}, {})
        if name == "bf16":
            jw = {k: v.astype("bfloat16") for k, v in jw.items()}
            tw = {k: v.bfloat16() for k, v in tw.items()}
        jsrv.add_model(name, jsyms[name], jw, {},
                       input_shapes={"data": example})
        tsrv.add_model(name, tsyms[name], tw, {},
                       input_shapes={"data": example})
    try:
        with jsrv:
            jout = _serve_bursts(jsrv, tenants)
            jst = jsrv.stats()
        with tsrv:
            tout = _serve_bursts(tsrv, tenants)
            tst = tsrv.stats()
    finally:
        jserving.clear_cache()
    for name, _, _, _, tol in tenants:
        for b in range(len(BURSTS)):
            for j, t in zip(jout[name, b], tout[name, b]):
                assert t.dtype == (torch.bfloat16 if name == "bf16"
                                   else torch.float32)
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(j, np.float32), **tol)
    for key in ("batches", "rows_real", "rows_padded", "occupancy",
                "completed", "retraces"):
        assert tst[key] == jst[key], key
    assert tst["batches"] == 6 and tst["occupancy"] == {
        "4": {"batches": 3, "mean_fill": 0.75},
        "8": {"batches": 3, "mean_fill": 1.0}}
    assert tst["aot_compiles"] == jst["aot_compiles"] == 12
