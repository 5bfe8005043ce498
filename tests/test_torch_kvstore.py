"""The port's KVStore on the CPU: every case of ``tests/test_kvstore.py``
through both packages, the stores ``Module`` takes on one device, and the
slice as a whole: ``Module.fit`` on a small ResNet from a RecordIO file
through ``ImageRecordIter`` -> ``DeviceCacheIter`` with a
``dist_sync_tpu`` store, in both packages from the same weights.

Tolerance of the last: float32 on both sides, products and sums in
another order (the JAX package's fused Module splits the batch over the
tests' 8 virtual CPU devices): parameters and moving statistics within a
relative norm of 1e-5, as ``tests/test_torch_module_fused.py`` holds the
fused Module."""
import io as pio

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as mx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import models as jax_models

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv

SHAPE = (4, 4)
KEYS = [5, 7, 11]
REL_TOL = 1e-5


class _Pkg:
    """One package's surface for the cases: its nd, kvstore, optimizer."""

    def __init__(self, name):
        self.name = name
        self.mx = mt if name == "port" else mx
        self.kv = tkv if name == "port" else jkv

    def zeros(self, shape=SHAPE):
        return self.mx.nd.zeros(shape, ctx=self.mx.cpu())

    def ones(self, shape=SHAPE):
        return self.mx.nd.ones(shape, ctx=self.mx.cpu())


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return _Pkg(request.param)


def _init_kv(pkg, kind="local"):
    kv = pkg.kv.create(kind)
    kv.init(3, pkg.zeros())
    kv.init(KEYS, [pkg.zeros()] * len(KEYS))
    return kv


def _check(arr, x):
    assert np.sum(np.abs(arr.asnumpy() - x)) == 0, arr.asnumpy()


def test_single_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(3, pkg.ones())
    out = pkg.zeros()
    kv.pull(3, out=out)
    _check(out, 1)


def test_list_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(KEYS, [pkg.ones() * 4] * len(KEYS))
    outs = [pkg.zeros() for _ in KEYS]
    kv.pull(KEYS, out=outs)
    for out in outs:
        _check(out, 4)


def test_aggregator(pkg):
    """Values pushed from N devices are summed (reference
    ``test_kvstore.py:40``)."""
    kv = _init_kv(pkg)
    num_devs = 4
    kv.push(3, [pkg.ones() for _ in range(num_devs)])
    outs = [pkg.zeros() for _ in range(num_devs)]
    kv.pull(3, out=outs)
    for out in outs:
        _check(out, num_devs)
    kv.push(KEYS, [[pkg.ones() * 2.0] * num_devs] * len(KEYS))
    outs = [[pkg.zeros() for _ in range(num_devs)] for _ in KEYS]
    kv.pull(KEYS, out=outs)
    for o in outs:
        for out in o:
            _check(out, num_devs * 2.0)


def test_updater(pkg):
    kv = _init_kv(pkg)

    def updater(key, recv, local):
        local += recv

    kv._set_updater(updater)
    kv.push(3, [pkg.ones()] * 4)
    out = pkg.zeros()
    kv.pull(3, out=out)
    _check(out, 4)
    kv.push(3, [pkg.ones()] * 4)
    kv.pull(3, out=out)
    _check(out, 8)


def test_set_optimizer_test_optimizer(pkg):
    kv = _init_kv(pkg)
    kv.set_optimizer(pkg.mx.optimizer.Test())
    kv.push(3, pkg.ones())
    out = pkg.zeros()
    kv.pull(3, out=out)
    _check(out, 1)


def test_dist_sync_tpu_single_process(pkg):
    kv = pkg.kv.create("dist_sync_tpu")
    assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "dist_sync_tpu")
    kv.init(3, pkg.zeros())
    kv.push(3, pkg.ones() * 3)
    out = pkg.zeros()
    kv.pull(3, out=out)
    _check(out, 3)


def test_dist_async_raises(pkg):
    with pytest.raises(pkg.mx.MXNetError, match="dist_async"):
        pkg.kv.create("dist_async")


def test_get_type(pkg):
    assert pkg.kv.create("local").type == "local"


def test_the_stores_and_their_errors_match():
    for kind in ("local", "device", "dist_sync", "dist_device_sync", "dist"):
        port, ref = tkv.create(kind), jkv.create(kind)
        assert (port.type, port.rank, port.num_workers) == \
            (ref.type, ref.rank, ref.num_workers)
    for bad in ("dist_async", "nope"):
        with pytest.raises(mt.MXNetError) as got:
            tkv.create(bad)
        with pytest.raises(mx.MXNetError) as want:
            jkv.create(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        tkv.create(3)


def test_a_dist_store_over_several_processes_raises(monkeypatch):
    """A dist store takes its rank and worker count from the process
    group (several processes are ported: ``test_torch_dist_parallel``);
    a rank other than 0 refuses to save the optimizer state, as the JAX
    package's does, and ``dist_async`` still raises."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    kv = tkv.create("dist_sync_tpu")
    assert (kv.rank, kv.num_workers) == (3, 4)
    kv.set_optimizer(mt.optimizer.SGD())
    with pytest.raises(mt.MXNetError, match="rank-0-only"):
        kv.save_optimizer_states("unused.states")
    with pytest.raises(mt.MXNetError, match="dist_async"):
        tkv.create("dist_async")
    assert tkv.create("local").num_workers == 1


def test_optimizer_states_round_trip(tmp_path):
    kv = _init_kv(_Pkg("port"))
    with pytest.raises(mt.MXNetError, match="Cannot save"):
        kv.save_optimizer_states(str(tmp_path / "s"))
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    with mt.cpu():
        kv.push(3, mt.nd.ones(SHAPE))
        kv.save_optimizer_states(str(tmp_path / "s"))
        kv.push(3, mt.nd.ones(SHAPE))
        moved = kv._updater.states[3].asnumpy()
        kv.load_optimizer_states(str(tmp_path / "s"))
    np.testing.assert_allclose(kv._updater.states[3].asnumpy(),
                               np.full(SHAPE, -0.1, np.float32))
    assert not np.allclose(moved, -0.1)


# ----------------------------------------------------------------- Module
def _mlp(pkg_mx):
    data = pkg_mx.sym.Variable("data")
    net = pkg_mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg_mx.sym.Activation(net, act_type="relu")
    net = pkg_mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg_mx.sym.SoftmaxOutput(net, name="softmax")


def _mlp_data():
    rng = np.random.RandomState(0)
    return (rng.normal(0, 1, (16, 10)).astype("f"),
            rng.randint(0, 3, 16).astype("f"))


@pytest.mark.parametrize("fused", ["always", "never"])
@pytest.mark.parametrize("kvstore", ["dist_sync_tpu", "object", "local"])
def test_module_takes_a_store_on_one_device(monkeypatch, fused, kvstore):
    """A store object or a dist string on one device: the fused path
    keeps its Trainer; on the classic path the store owns the update (a
    dist string) or a local updater runs, as in the JAX package.  Both
    end where the JAX package's classic path ends."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", fused)
    x, y = _mlp_data()
    rng = np.random.RandomState(3)
    shapes = dict(fc1_weight=(8, 10), fc1_bias=(8,), fc2_weight=(3, 8),
                  fc2_bias=(3,))
    init = {n: rng.normal(0, 0.3, s).astype("f") for n, s in shapes.items()}
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    with mt.cpu():
        store = tkv.create("dist_sync_tpu") if kvstore == "object" \
            else kvstore
        mod = mt.mod.Module(_mlp(mt))
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                kvstore=store,
                arg_params={n: mt.nd.array(v) for n, v in init.items()},
                **opt)
    assert (mod._trainer is not None) == (fused == "always")
    assert mod._update_on_kvstore == (fused == "never"
                                      and kvstore != "local")
    jmod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "never")
    jmod.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
             kvstore=jkv.create("dist_sync_tpu") if kvstore == "object"
             else kvstore,
             arg_params={n: mx.nd.array(v) for n, v in init.items()}, **opt)
    got, _ = mod.get_params()
    want, _ = jmod.get_params()
    for n, w in want.items():
        w = w.asnumpy()
        assert np.linalg.norm(got[n].asnumpy() - w) \
            <= REL_TOL * np.linalg.norm(w), n


def test_classic_store_update_saves_its_optimizer_states(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "never")
    x, y = _mlp_data()
    with mt.cpu():
        mod = mt.mod.Module(_mlp(mt))
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                kvstore="dist_sync", optimizer="sgd",
                optimizer_params={"momentum": 0.9})
        assert mod._update_on_kvstore
        mod.save_optimizer_states(str(tmp_path / "s"))
        mod.load_optimizer_states(str(tmp_path / "s"))
    assert set(mod._kvstore._updater.states) == {0, 1, 2, 3}


# ------------------------------------------------------- the slice, whole
RESNET = dict(num_classes=4, num_layers=8, image_shape=(32, 32, 3),
              layout="NHWC")
BATCH = 8


@pytest.fixture(scope="module")
def resnet_rec(tmp_path_factory):
    """16 JPEG records of 36 x 36, labels i % 4."""
    rec = str(tmp_path_factory.mktemp("slice") / "img.rec")
    w = mx.recordio.MXRecordIO(rec, "w")
    rng = np.random.RandomState(5)
    for i in range(16):
        buf = pio.BytesIO()
        Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)
                        ).save(buf, format="JPEG", quality=90)
        w.write(mx.recordio.pack(mx.recordio.IRHeader(0, float(i % 4), i, 0),
                                 buf.getvalue()))
    w.close()
    return rec


def test_resnet_fits_from_records_as_the_jax_package(resnet_rec,
                                                     monkeypatch):
    """Two steps of ``Module.fit`` (one epoch of 16 records at batch 8)
    on the fused path with a ``dist_sync_tpu`` store, fed by
    ``ImageRecordIter`` (the native loader, uint8 NHWC at 36^2) ->
    ``DeviceCacheIter`` (centre crop to 32^2, mean/std on the device),
    from the same initial weights in both packages.  The CIFAR-form
    ResNet has no BatchNorm on its data: fed raw bytes, its first
    convolution works at activations of ~100, where the packages' float32
    sums in another order end 1.7e-4 apart after two steps (measured);
    normalised as image pipelines feed it, 3.7e-6."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "always")
    jsym = jax_models.get_symbol("resnet", **RESNET)
    args, _, auxs = jsym.infer_shape(data=(BATCH, 32, 32, 3))
    rng = np.random.RandomState(6)
    arg = {n: (np.ones(s) if n.endswith("_gamma") else
               rng.normal(0, 0.2, s)).astype("f")
           for n, s in zip(jsym.list_arguments(), args)
           if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s))
           .astype("f") for n, s in zip(jsym.list_auxiliary_states(), auxs)}
    loader = dict(path_imgrec=resnet_rec, data_shape=(3, 36, 36),
                  batch_size=BATCH, layout="NHWC", dtype="uint8",
                  output="numpy", preprocess_threads=2)
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.05, "momentum": 0.9})

    stats = dict(mean=(124.0, 116.0, 104.0), std=(58.0, 57.0, 57.5))
    jit = mx.io.DeviceCacheIter(mx.io.ImageRecordIter(**loader),
                                data_shape=(32, 32), **stats)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.fit(jit, num_epoch=1, kvstore=mx.kvstore.create("dist_sync_tpu"),
             arg_params={n: mx.nd.array(v) for n, v in arg.items()},
             aux_params={n: mx.nd.array(v) for n, v in aux.items()}, **opt)
    assert jmod._trainer is not None

    native = mt.io.ImageRecordIter(**loader)
    assert isinstance(native, mt.io.NativeImageRecordIter)
    with mt.cpu():
        it = mt.io.DeviceCacheIter(native, data_shape=(32, 32), **stats)
        mod = mt.mod.Module(mt.models.get_symbol("resnet", **RESNET))
        mod.fit(it, num_epoch=1, kvstore=mt.kvstore.create("dist_sync_tpu"),
                arg_params={n: mt.nd.array(v) for n, v in arg.items()},
                aux_params={n: mt.nd.array(v) for n, v in aux.items()},
                **opt)
    assert mod._trainer is not None and mod._trainer.num_update == 2
    for got, want in zip(mod.get_params(), jmod.get_params()):
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            w = w.asnumpy()
            assert np.linalg.norm(got[n].asnumpy() - w) \
                <= REL_TOL * np.linalg.norm(w), n
