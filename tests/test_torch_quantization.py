"""The port's ``contrib.quantization`` and the server's int8 tier against
the JAX package on the CPU.

The quantized weights and scales are made on the host with numpy in
both packages, so they are compared bitwise (dtype and bytes), and so
are the quant tags, the emitted symbols' JSON and the calibration
digests (a calibration that reads only inputs, not activations the two
packages compute, is bitwise too).  A quantized model's forward on the
port is held to the JAX package's within 1e-5 of the largest output
(``torch_parity.rel_err``; float32 products summed in another order)
and to the float model's argmax on every row.  The server's int8 tier
admits only quantized tenants and counts their int8 weights at one
byte an element."""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq

from torch_parity import rel_err

PKGS = ((mx, jq), (mt, tq))


def _convnet(pkg):
    data = pkg.sym.Variable("data")
    n = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
    n = pkg.sym.Activation(n, act_type="relu")
    n = pkg.sym.Convolution(n, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv2")
    n = pkg.sym.BatchNorm(n, name="bn")
    n = pkg.sym.Flatten(n)
    n = pkg.sym.FullyConnected(n, num_hidden=32, name="fc1")
    n = pkg.sym.Activation(n, act_type="relu")
    n = pkg.sym.FullyConnected(n, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


def _convnet_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"conv1_weight": (8, 1, 3, 3), "conv1_bias": (8,),
              "conv2_weight": (8, 8, 3, 3), "conv2_bias": (8,),
              "bn_gamma": (8,), "bn_beta": (8,),
              "fc1_weight": (32, 512), "fc1_bias": (32,),
              "fc2_weight": (4, 32), "fc2_bias": (4,)}
    args = {k: (rng.randn(*s) * 0.2).astype("f") for k, s in shapes.items()}
    aux = {"bn_moving_mean": (rng.randn(8) * 0.1).astype("f"),
           "bn_moving_var": (rng.rand(8) + 0.5).astype("f")}
    x = rng.randn(64, 1, 8, 8).astype("f")
    return args, aux, x


def _ranker(pkg, vocab=600, dim=16, slots=8, classes=8):
    ids = pkg.sym.Variable("ids")
    e = pkg.sym.Embedding(ids, input_dim=vocab, output_dim=dim,
                          name="embed")
    h = pkg.sym.sum(e, axis=1)
    h = pkg.sym.FullyConnected(h, num_hidden=32, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _ranker_params(seed=0, vocab=600, dim=16, classes=8):
    rng = np.random.RandomState(seed)
    args = {"embed_weight": rng.randn(vocab, dim).astype("f") * 0.3,
            "fc1_weight": rng.randn(32, dim).astype("f") * 0.3,
            "fc1_bias": np.zeros(32, "f"),
            "fc2_weight": rng.randn(classes, 32).astype("f") * 0.3,
            "fc2_bias": np.zeros(classes, "f")}
    ids = rng.randint(0, vocab, (64, 8)).astype("f")
    return args, ids


def _host(d):
    """``name -> (dtype name, host array)``; bfloat16 widened to float32
    (exact), as the port's ``asnumpy`` returns it."""
    out = {}
    for k, v in d.items():
        dt = str(v.dtype).replace("torch.", "")
        a = np.asarray(v.asnumpy())
        out[k] = (dt, a.astype(np.float32) if dt == "bfloat16" else a)
    return out


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k][0] == want[k][0], (k, got[k][0], want[k][0])
        assert got[k][1].tobytes() == want[k][1].tobytes(), k


def _run_both(fn):
    """``fn(pkg, q)`` in both packages (the port's on the CPU):
    ``(port, jax)``."""
    with mx.name.NameManager():
        want = fn(mx, jq)
    with mt.cpu(), mt.name.NameManager():
        got = fn(mt, tq)
    return got, want


def _forward(pkg, sym, args, aux, data, name="data"):
    mod = pkg.mod.Module(sym, data_names=(name,), context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc(name, data.shape)],
             label_shapes=[("softmax_label", (data.shape[0],))],
             for_training=False)
    mod.set_params(args, aux)
    mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(data)],
                                 label=[pkg.nd.zeros((data.shape[0],))]),
                is_train=False)
    return mod.get_outputs()[0].asnumpy(), mod


@pytest.mark.parametrize("shape,axis", [((16, 40), 0), ((6, 3, 2, 2), 1),
                                        ((5, 7, 3), 2)])
def test_quantize_weight_is_bitwise_the_jax_one(shape, axis):
    w = np.random.RandomState(1).normal(0, 0.3, shape).astype("f")
    w[0] = 0.0                      # an all-zero channel: scale 1
    got, want = tq._quantize_weight(w, axis=axis), \
        jq._quantize_weight(w, axis=axis)
    _bitwise({"q": (str(got[0].dtype), got[0]),
              "s": (str(got[1].dtype), got[1])},
             {"q": (str(want[0].dtype), want[0]),
              "s": (str(want[1].dtype), want[1])})
    err = np.abs(got[0].astype("f") * got[1] - w)
    assert err.max() <= np.abs(w).max() / 127.0 + 1e-7


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_quantize_model_matches_the_jax_package(compute):
    args, aux, x = _convnet_params()

    def run(pkg, q):
        sym = _convnet(pkg)
        qsym, qargs, qaux = q.quantize_model(
            sym, {k: pkg.nd.array(v) for k, v in args.items()},
            {k: pkg.nd.array(v) for k, v in aux.items()}, min_elems=100,
            compute_dtype=compute)
        return qsym, _host(qargs), q.quant_tag(qsym)

    (tsym, targs, ttag), (jsym, jargs, jtag) = _run_both(run)
    _bitwise(targs, jargs)
    assert ttag == jtag and json.loads(ttag)["compute"] == compute
    assert tsym.tojson() == jsym.tojson()
    assert "fc1_weight_quant" in targs and "conv1_weight" in targs
    assert targs["fc1_weight_quant"][0] == "int8"


def test_a_quantized_forward_binds_int8_and_matches_the_jax_one():
    args, aux, x = _convnet_params()
    outs = []
    for pkg, q in PKGS:
        with pkg.cpu():
            sym = _convnet(pkg)
            a = {k: pkg.nd.array(v) for k, v in args.items()}
            b = {k: pkg.nd.array(v) for k, v in aux.items()}
            ref, _ = _forward(pkg, sym, a, b, x)
            qsym, qargs, qaux = q.quantize_model(sym, a, b, min_elems=100)
            got, mod = _forward(pkg, qsym, qargs, qaux, x)
            outs.append((ref, got))
    exe = mod._exec_group.execs[0]
    assert exe.arg_dict["fc1_weight_quant"].dtype == np.int8 or \
        str(exe.arg_dict["fc1_weight_quant"].dtype) == "torch.int8"
    (jref, jgot), (tref, tgot) = outs
    assert rel_err(tgot, jgot) <= 1e-5
    assert rel_err(tref, jref) <= 1e-5
    assert (tgot.argmax(1) == tref.argmax(1)).all()


@pytest.mark.parametrize("mode", ["minmax", "percentile"])
def test_calibrate_model_matches_the_jax_package(mode):
    """Both modes on the convnet: weights, activation scales, the
    emitted symbol, the tag, the report's findings; an MLP whose only
    calibrated activation is its input gives the same digest too."""
    args, aux, x = _convnet_params()

    def run(pkg, q):
        sym = _convnet(pkg)
        it = pkg.io.NDArrayIter({"data": x}, None, 16)
        qsym, qargs, _, cal = q.calibrate_model(
            sym, {k: pkg.nd.array(v) for k, v in args.items()},
            {k: pkg.nd.array(v) for k, v in aux.items()}, calib_iter=it,
            min_elems=64, calib_mode=mode, percentile=99.5)
        return (qsym.tojson(), _host(qargs), q.quant_tag(qsym), cal,
                [(f.rule, f.node, f.op) for f in cal.report.findings])

    got, want = _run_both(run)
    assert got[0] == want[0] and got[2] == want[2] and got[4] == want[4]
    weights = {k: v for k, v in want[1].items()
               if not k.endswith("_act_quant_scale")}
    _bitwise({k: got[1][k] for k in weights}, weights)
    tcal, jcal = got[3], want[3]
    assert tcal.config == jcal.config and tcal.weight_axes == jcal.weight_axes
    assert sorted(tcal.act_scales) == sorted(jcal.act_scales)
    for k in jcal.act_scales:
        np.testing.assert_allclose(tcal.act_ranges[k], jcal.act_ranges[k],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[1][k][1], want[1][k][1], rtol=1e-5)
    np.testing.assert_array_equal(got[1]["data_act_quant_scale"][1],
                                  want[1]["data_act_quant_scale"][1])

    def mlp(pkg, q):
        d = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
        h = pkg.sym.FullyConnected(pkg.sym.Activation(h, act_type="relu"),
                                   num_hidden=4, name="fc2")
        sym = pkg.sym.SoftmaxOutput(h, name="softmax")
        p = {"fc1_weight": args["fc1_weight"][:16, :64],
             "fc1_bias": args["fc1_bias"][:16],
             "fc2_weight": args["fc2_weight"][:, :16],
             "fc2_bias": args["fc2_bias"]}
        it = pkg.io.NDArrayIter({"data": x.reshape(64, 64)}, None, 16)
        return q.calibrate_model(sym, {k: pkg.nd.array(v)
                                       for k, v in p.items()}, {},
                                 calib_iter=it, min_elems=64,
                                 calib_mode=mode)[3].digest

    got, want = _run_both(mlp)
    assert got == want


def test_calibration_is_deterministic_and_the_digest_tells_models_apart():
    def cal(seed):
        args, ids = _ranker_params(seed)
        with mt.cpu(), mt.name.NameManager():
            it = mt.io.NDArrayIter({"ids": ids}, None, 16)
            return tq.calibrate_model(
                _ranker(mt), {k: mt.nd.array(v) for k, v in args.items()},
                {}, calib_iter=it, quantize_op_names=("Embedding",),
                min_elems=64)

    a, b, c = cal(0), cal(0), cal(3)
    assert a[0].tojson() == b[0].tojson() and a[3].digest == b[3].digest
    _bitwise(_host(a[1]), _host(b[1]))
    assert a[3].digest != c[3].digest
    rules = {f.rule for f in a[3].report.findings}
    assert {"quant-weight", "quant-keep-float"} <= rules
    assert a[3].to_dict()["digest"] == a[3].digest


def test_embedding_tables_dequantize_after_the_gather():
    """The int8 table is gathered, then each row is scaled: the
    Embedding node reads the int8 variable, and the forward matches the
    JAX package's."""
    args, ids = _ranker_params()

    def run(pkg, q):
        qsym, qargs, _ = q.quantize_model(
            _ranker(pkg), {k: pkg.nd.array(v) for k, v in args.items()},
            quantize_op_names=("Embedding",), min_elems=64)
        out, _ = _forward(pkg, qsym, qargs, {}, ids[:8], name="ids")
        return qsym, _host(qargs), out

    (tsym, targs, tout), (jsym, jargs, jout) = _run_both(run)
    _bitwise(targs, jargs)
    assert rel_err(tout, jout) <= 1e-5
    node = [n for n in json.loads(tsym.tojson())["nodes"]
            if n["name"] == "embed"][0]
    nodes = json.loads(tsym.tojson())["nodes"]
    assert nodes[node["inputs"][1][0]]["name"] == "embed_weight_quant"
    assert targs["embed_weight_quant"][0] == "int8"


def test_the_selection_rules_match_the_jax_package():
    """A weight shared with an excluded consumer or a non-quantizable
    one stays float; nothing to quantize raises; Deconvolution scales
    ride its axis 1."""
    w = np.random.RandomState(0).rand(8, 32).astype("f")
    for pkg, q in PKGS:
        with pkg.cpu():
            data, sw = pkg.sym.Variable("data"), \
                pkg.sym.Variable("shared_weight")
            a = pkg.sym.FullyConnected(data, weight=sw, num_hidden=8,
                                       no_bias=True, name="fca")
            b = pkg.sym.FullyConnected(data, weight=sw, num_hidden=8,
                                       no_bias=True, name="fcb")
            net = pkg.sym.SoftmaxOutput(a + b, name="softmax")
            params = {"shared_weight": pkg.nd.array(w)}
            with pytest.raises(pkg.base.MXNetError):
                q.quantize_model(net, params, min_elems=1,
                                 excluded_sym_names=("fca",))
            assert "shared_weight_quant" in q.quantize_model(
                net, params, min_elems=1)[1]
            tied = pkg.sym.SoftmaxOutput(
                pkg.sym.FullyConnected(data, weight=sw, num_hidden=8,
                                       no_bias=True, name="fcc")
                + pkg.sym.sum(sw), name="softmax")
            with pytest.raises(pkg.base.MXNetError):
                q.quantize_model(tied, params, min_elems=1)

    wd = (np.random.RandomState(0).rand(3, 6, 2, 2)
          * np.arange(1, 7)[None, :, None, None]).astype("f")

    def deconv(pkg, q):
        net = pkg.sym.Deconvolution(pkg.sym.Variable("data"),
                                    kernel=(2, 2), stride=(2, 2),
                                    num_filter=6, no_bias=True, name="up")
        return _host(q.quantize_model(net, {"up_weight": pkg.nd.array(wd)},
                                      min_elems=1)[1])

    got, want = _run_both(deconv)
    _bitwise(got, want)
    assert got["up_weight_quant_scale"][1].shape == (1, 6, 1, 1)


def test_the_accuracy_gate_passes_clean_and_refuses_clipped_scales():
    """The gate on a magnitude-coded MLP whose thresholds saturate when
    the calibration data is far smaller than what it serves."""
    rng = np.random.RandomState(0)
    base = np.abs(rng.normal(0, 1, 16)).astype("f")
    base /= base.mean()
    mags = np.array([0.6, 1.1, 1.6, 2.1], "f")
    y = rng.randint(0, 4, 256)
    x = (mags[y][:, None] * base[None, :]
         + 0.05 * rng.normal(0, 1, (256, 16))).astype("f")
    a = 4.0
    args = {"fc1_weight": np.full((3, 16), 1.0 / 16.0, "f"),
            "fc1_bias": np.array([-0.85, -1.35, -1.85], "f"),
            "fc2_weight": np.array([[-a, 0, 0], [a, -2 * a, 0],
                                    [0, 2 * a, -4 * a], [0, 0, 4 * a]],
                                   "f"),
            "fc2_bias": np.array([0.05, 0, 0, 0], "f")}
    with mt.cpu():
        d = mt.sym.Variable("data")
        h = mt.sym.Activation(mt.sym.FullyConnected(d, num_hidden=3,
                                                    name="fc1"),
                              act_type="relu")
        sym = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            h, num_hidden=4, name="fc2"), name="softmax")
        nd_args = {k: mt.nd.array(v) for k, v in args.items()}
        ref, _ = _forward(mt, sym, nd_args, {}, x)
        gates = []
        for calib in (x, (x * 0.02).astype("f")):
            it = mt.io.NDArrayIter({"data": calib}, None, 64)
            qsym, qargs, qaux, _ = tq.calibrate_model(
                sym, nd_args, {}, calib_iter=it, min_elems=1)
            got, _ = _forward(mt, qsym, qargs, qaux, x)
            gates.append(tq.evaluate_gate(ref, got, y, 0.99, 0.5))
    clean, clipped = gates
    assert clean["passed"] and not clipped["passed"], gates
    assert clipped["argmax_agreement"] < clean["argmax_agreement"]


def _quantized_ranker():
    args, ids = _ranker_params()
    with mt.cpu():
        sym = _ranker(mt)
        nd_args = {k: mt.nd.array(v) for k, v in args.items()}
        it = mt.io.NDArrayIter({"ids": ids}, None, 16)
        qsym, qargs, qaux, _ = tq.calibrate_model(
            sym, nd_args, {}, calib_iter=it, min_elems=64)
    return sym, nd_args, qsym, qargs, qaux, ids


def test_the_int8_tier_admits_quantized_tenants_only(monkeypatch):
    sym, args, qsym, qargs, qaux, _ = _quantized_ranker()
    with mt.cpu():
        srv = mt.serving.ModelServer(buckets=[1], precision="int8",
                                     ctx=mt.cpu())
        with pytest.raises(MXNetError, match="not quantized"):
            srv.add_model("f", sym, args, {}, input_shapes={"ids": (8,)})
        for tier in ("float32", "bfloat16"):
            srv = mt.serving.ModelServer(buckets=[1], precision=tier,
                                         ctx=mt.cpu())
            with pytest.raises(MXNetError, match="quantized"):
                srv.add_model("q", qsym, qargs, qaux,
                              input_shapes={"ids": (8,)})
        with pytest.raises(MXNetError):
            mt.serving.ModelServer(buckets=[1], precision="int4",
                                   ctx=mt.cpu())
        monkeypatch.setenv("MXTPU_SERVE_PRECISION", "int8")
        assert mt.serving.ModelServer(buckets=[1],
                                      ctx=mt.cpu()).precision == "int8"
        assert mt.serving.ModelServer(buckets=[1], precision="auto",
                                      ctx=mt.cpu()).precision == "auto"


def test_int8_weights_count_one_byte_an_element():
    """The server's stats and load report, and a Predictor's bound
    table, hold int8 at one byte an element; the int8 tenant answers
    as the port's eager forward of the same symbol and weights, and
    ``auto`` serves both tiers side by side."""
    sym, args, qsym, qargs, qaux, ids = _quantized_ranker()
    with mt.cpu():
        srv = mt.serving.ModelServer(buckets=[1, 4], max_wait_us=100,
                                     precision="int8", ctx=mt.cpu())
        srv.add_model("r", qsym, qargs, qaux, input_shapes={"ids": (8,)})
        with srv:
            out = srv.predict(ids=ids[:4].astype(np.int32))[0]
            st = srv.stats()
            report = srv.load_report()
        want, _ = _forward(mt, qsym, qargs, qaux, ids[:4], name="ids")
        both = mt.serving.ModelServer(buckets=[4], max_wait_us=100,
                                      ctx=mt.cpu())
        both.add_model("f", sym, args, {}, input_shapes={"ids": (8,)})
        both.add_model("q", qsym, qargs, qaux, input_shapes={"ids": (8,)})
        with both:
            f = both.predict(ids=ids[:4].astype(np.int32), model="f")[0]
            g = both.predict(ids=ids[:4].astype(np.int32), model="q")[0]
    expected = sum(int(v.asnumpy().nbytes) for v in qargs.values())
    for rec in (st["per_model"]["r"], report["per_model"]["r"]):
        assert rec["weight_bytes_on_device"] == expected
        assert json.loads(rec["quant"])["dtype"] == "int8"
    assert qargs["embed_weight_quant"].asnumpy().nbytes * 4 == \
        args["embed_weight"].asnumpy().nbytes
    assert rel_err(np.asarray(out), want) <= 1e-6
    assert (np.asarray(f).argmax(1) == np.asarray(g).argmax(1)).mean() >= 0.75
    pred = mt.Predictor(qsym.tojson(),
                        _param_bytes(qargs), {"ids": (4, 8)},
                        dev_type="cpu")
    table = pred._params["embed_weight_quant"]
    assert table.dtype.itemsize == 1 and table.numel() == 600 * 16


def _param_bytes(qargs):
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "q.params")
        mt.nd.save(path, {"arg:" + k: v for k, v in qargs.items()})
        with open(path, "rb") as f:
            return f.read()


def test_a_quantized_symbol_survives_its_json():
    args, aux, x = _convnet_params()
    with mt.cpu():
        a = {k: mt.nd.array(v) for k, v in args.items()}
        b = {k: mt.nd.array(v) for k, v in aux.items()}
        qsym, qargs, qaux = tq.quantize_model(_convnet(mt), a, b,
                                              min_elems=64)
        back = mt.sym.load_json(qsym.tojson())
        assert back.list_arguments() == qsym.list_arguments()
        assert tq.quant_tag(back) == tq.quant_tag(qsym)
        ref, _ = _forward(mt, qsym, qargs, qaux, x[:16])
        got, _ = _forward(mt, back, qargs, qaux, x[:16])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
