"""The port's NDArray and ``mt.nd`` front-ends against ``mxnet_tpu``'s: every
case of ``tests/test_ndarray.py`` run through both packages (``mx.nd`` on
JAX's CPU, ``mt.nd`` under ``mt.cpu()``) on the same numpy inputs, plus
the port's own contracts (torch views, the ``gpu(0)`` default, no
fallback to the CPU)."""
import os
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import NDArray

# float32 on both sides; sums and products of several terms round in
# another order
TOL = dict(rtol=1e-6, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _dtype_name(a):
    return a.dtype.name if isinstance(a.dtype, np.dtype) \
        else str(a.dtype).replace("torch.", "")


def _both(scenario):
    """Run ``scenario(nd)`` through both packages; returns the two lists
    of NDArrays it made, after checking dtypes and shapes agree."""
    jout = scenario(mx.nd)
    with mt.cpu():
        tout = scenario(mt.nd)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
        assert _dtype_name(t) == _dtype_name(j)
    return jout, tout


def _close(scenario, tol=TOL):
    jout, tout = _both(scenario)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **tol)


_A = np.array([1.0, 2.0, 3.0], np.float32)
_B = np.array([4.0, 5.0, 6.0], np.float32)
_SIGNED = np.array([-7.5, -3.0, 2.0, 5.5, -1.25, 4.0], np.float32)
_DIVISORS = np.array([2.0, -2.0, 2.5, -4.0, 0.5, -3.0], np.float32)

SCENARIOS = {
    "creation": lambda nd: [
        nd.zeros((3, 4)), nd.ones((2,), dtype="int32"), nd.full((2, 2), 7.5),
        nd.array([[1, 2], [3, 4]]), nd.array([[1.5, 2.0]]),
        nd.arange(0, 10, 2), nd.arange(5), nd.empty((2, 3))],
    "elementwise": lambda nd: [
        nd.array(_A) + nd.array(_B), nd.array(_A) - nd.array(_B),
        nd.array(_A) * nd.array(_B), nd.array(_B) / nd.array(_A),
        nd.array(_A) + 1, 1 + nd.array(_A), 2 - nd.array(_A),
        6 / nd.array(_B), nd.array(_A) ** 2, -nd.array(_A)],
    # Python's modulo: the result takes the divisor's sign
    "mod_signs": lambda nd: [
        nd.array(_SIGNED) % nd.array(_DIVISORS), nd.array(_SIGNED) % 2.5,
        nd.array(_SIGNED) % -2.5,
        nd.array(np.array([-7, 7, -8, 9], np.int32))
        % nd.array(np.array([3, -3, 5, 4], np.int32))],
    # 0/1 in the input's dtype, float or int
    "comparison": lambda nd: [
        nd.array(_A) == nd.array(_A[::-1].copy()),
        nd.array(_A) != nd.array(_A[::-1].copy()),
        nd.array(_A) > nd.array(_A[::-1].copy()),
        nd.array(_A) >= nd.array(_A[::-1].copy()),
        nd.array(_A) < nd.array(_A[::-1].copy()),
        nd.array(_A) <= 2.0, nd.array(_A) > 1.5,
        nd.array(np.array([1, 5, 3], np.int32))
        >= nd.array(np.array([2, 5, 1], np.int32)),
        nd.array(np.array([1, 5, 3], np.int32)) == 5],
    "copyto_astype": lambda nd: [
        nd.array([1.5, 2.5]).copyto(nd.zeros((2,))),
        nd.array([1.5, -2.5]).astype("int32"),
        nd.array([1.5, 2.5]).copyto(nd.zeros((2,), dtype="int32")),
        nd.array([3.0, 4.0]).copy()],
    "generated_front_ends": lambda nd: [
        nd.sqrt(nd.array(_B)), nd.log(nd.array(_B)),
        nd.relu(nd.array(_SIGNED)), nd.clip(nd.array(_SIGNED), a_min=-2,
                                             a_max=3),
        nd.broadcast_maximum(nd.array(_SIGNED.reshape(2, 3)),
                             nd.array(_A.reshape(1, 3))),
        nd.Reshape(nd.array(_SIGNED), shape=(3, 2)),
        nd.slice_axis(nd.array(_SIGNED.reshape(2, 3)), axis=1, begin=1,
                      end=3),
        nd.expand_dims(nd.array(_A), axis=0),
        nd.Concat(nd.array(_A), nd.array(_B), num_args=2, dim=0),
        nd.FullyConnected(data=nd.array(_SIGNED.reshape(2, 3)),
                          weight=nd.array(np.ones((4, 3), np.float32)),
                          num_hidden=4, no_bias=True),
        nd.one_hot(nd.array([0, 2, 9]), depth=3),
        nd.argmax(nd.array(_SIGNED.reshape(2, 3)), axis=1),
        nd.transpose(nd.array(_SIGNED.reshape(2, 3))),
        nd.array(_SIGNED.reshape(2, 3)).T,
        nd.moveaxis(nd.array(_SIGNED.reshape(1, 2, 3)), 0, 2),
        nd.concatenate([nd.array(_A), nd.array(_B)]),
        nd.array(_A).broadcast_to((2, 3)),
        nd.Cast(nd.array(_SIGNED), dtype="int32"),
        nd._zeros(shape=(2, 0)), nd.ones_like(nd.array(_A))],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_matches_mxnet_tpu(name):
    _close(SCENARIOS[name])


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
def test_float_to_integer_casts_saturate_as_the_jax_package(dtype):
    """``Cast`` and ``astype`` from float truncate toward zero and
    saturate at the integer type's range, NaN giving 0, exactly as the
    JAX package's ``astype``; ``.to`` wrapped (uint8 300 -> 44)."""
    x = np.array([-1.7, 2.7, 300.0, np.nan, 3e9, -3e9, -0.5, 255.9], "f")
    want = mx.nd.array(x).astype(dtype).asnumpy()
    with mt.cpu():
        for got in (mt.nd.array(x).astype(dtype),
                    mt.nd.Cast(mt.nd.array(x), dtype=dtype)):
            assert got.asnumpy().dtype == want.dtype
            np.testing.assert_array_equal(got.asnumpy(), want)


def test_reductions_and_dot_match_mxnet_tpu():
    """``test_ndarray.py::test_generated_ops``' sum and dot, at 1e-5."""
    a = np.abs(np.random.RandomState(0).randn(3, 4)).astype("f") + 0.5
    _close(lambda nd: [nd.sum(nd.array(a)),
                       nd.dot(nd.array(a), nd.transpose(nd.array(a))),
                       nd.sum(nd.array(a), axis=1, keepdims=True),
                       nd.mean(nd.array(a), axis=0), nd.norm(nd.array(a)),
                       nd.batch_dot(nd.array(a[None]),
                                    nd.array(a.T[None].copy()))],
           SUM_TOL)


def _mutations(nd):
    a = nd.ones((2, 2))
    a += 1
    b = a.copy()
    a *= 3
    c = a.copy()
    a -= 2
    d = a.copy()
    a /= 4
    e = nd.array(_A)
    e += nd.array(_B)
    return [b, c, d, a, e]


def _views(nd):
    """Views write through to their base (reference ndarray.h:284-310)."""
    a = nd.zeros((4, 3))
    s = a[1:3]
    s[:] = 5
    row = a[0]
    row[:] = 7
    a[3] = np.array([1, 2, 3])
    r = nd.arange(0, 6)
    v = r.reshape((2, 3))
    v[1] = 9
    w = r.reshape((3, -1))
    return [a, s, row, r, v, w]


def _setitem(nd):
    a = nd.zeros((3, 3))
    a[:] = 1
    b = a.copy()
    a[1] = 2
    c = a.copy()
    a[0:2] = np.arange(6).reshape(2, 3)
    d = a.copy()
    a[2:] = nd.array([[4.0, 5.0, 6.0]])
    return [b, c, d, a]


def _onehot(nd):
    out = nd.zeros((4, 3))
    nd.onehot_encode(nd.array([0, 2, 1, 5]), out)
    return [out]


def _out_and_named(nd):
    x = nd.array(_SIGNED)
    y = nd.zeros((6,))
    res = nd.abs(x, out=y)
    z = nd.broadcast_add(lhs=nd.array(_A), rhs=nd.array(_B))
    return [y, res, z]


@pytest.mark.parametrize("scenario", [_mutations, _views, _setitem, _onehot,
                                      _out_and_named],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_mutation_matches_mxnet_tpu(scenario):
    _close(scenario)


def test_views_are_torch_views():
    with mt.cpu():
        a = mt.nd.zeros((4, 3))
        s, row, r = a[1:3], a[2], a.reshape((2, 6))
    for v in (s, row, r):
        assert v.data.untyped_storage().data_ptr() \
            == a.data.untyped_storage().data_ptr()
    row[:] = 4
    assert torch.equal(s.data[1], torch.full((3,), 4.0))
    assert torch.equal(r.data[1, :3], torch.full((3,), 4.0))
    with pytest.raises(mt.MXNetError, match="shape"):
        s._set_data(torch.zeros(3, 3))
    with pytest.raises(mt.MXNetError, match="slice step"):
        a[::2]


def test_op_outputs_own_their_memory():
    """An op that returns a view of its input (Reshape, identity) gives
    a new NDArray, as ``mx.nd`` does: writing it leaves the input be."""
    def scenario(nd):
        x = nd.array(_SIGNED)
        y = nd.Reshape(x, shape=(2, 3))
        y[:] = 0
        z = nd.identity(x)
        z[:] = 1
        return [x, y, z]
    _close(scenario)


def test_save_load_roundtrip(tmp_path):
    fname = str(tmp_path / "x.params")
    rng = np.random.RandomState(0)
    with mt.cpu():
        arrs = {"w": mt.nd.array(rng.randn(3, 4).astype("f")),
                "b": mt.nd.array(rng.randn(4).astype("f"))}
        mt.nd.save(fname, arrs)
        loaded = mt.nd.load(fname)
        assert set(loaded) == {"w", "b"}
        for k in arrs:
            assert isinstance(loaded[k], NDArray)
            np.testing.assert_array_equal(loaded[k].asnumpy(),
                                          arrs[k].asnumpy())
        mt.nd.save(fname, [arrs["w"]])
        loaded = mt.nd.load(fname)
        assert isinstance(loaded, list)
        np.testing.assert_array_equal(loaded[0].asnumpy(),
                                      arrs["w"].asnumpy())
        mt.nd.save(fname, arrs["b"])
        assert mt.nd.load(fname)[0].shape == (4,)


@pytest.mark.parametrize("direction", ["mt_to_mx", "mx_to_mt"])
def test_params_round_trip_between_packages(tmp_path, direction):
    """The same arrays give byte-identical files from both packages, and
    each package reads the other's."""
    rng = np.random.RandomState(1)
    vals = {"arg:w": rng.randn(3, 5).astype("f"),
            "arg:i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "aux:m": rng.randn(4).astype("f")}
    with mt.cpu():
        mt.nd.save(str(tmp_path / "t.params"),
                   {k: mt.nd.array(v) for k, v in vals.items()})
    mx.nd.save(str(tmp_path / "j.params"),
               {k: mx.nd.array(v) for k, v in vals.items()})
    assert (tmp_path / "t.params").read_bytes() \
        == (tmp_path / "j.params").read_bytes()
    if direction == "mt_to_mx":
        loaded = mx.nd.load(str(tmp_path / "t.params"))
    else:
        loaded = mt.nd.load(str(tmp_path / "j.params"))
        assert all(a.context == mt.cpu() for a in loaded.values())
        args, _ = mt.convert.params_from_mxnet_tpu(loaded, {})
        for k, v in vals.items():
            assert torch.equal(args[k], torch.from_numpy(v))
    for k, v in vals.items():
        assert _dtype_name(loaded[k]) == v.dtype.name
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)


def test_binary_format_layout():
    """The on-disk header matches the reference format magic."""
    import struct
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "x.params")
        mt.nd.save(fname, {"a": mt.nd.ones((2,), ctx=mt.cpu())})
        with open(fname, "rb") as f:
            magic, _ = struct.unpack("<QQ", f.read(16))
        assert magic == 0x112


def test_wait_and_context():
    with mt.cpu():
        a = mt.nd.ones((2, 2))
    a.wait_to_read()
    a.wait_to_write()
    mt.nd.waitall()
    assert a.context == mt.cpu() and a.ctx.device_type == "cpu"
    assert a.as_in_context(mt.cpu()) is a


def test_truthiness_and_autograd_raise():
    a = mt.nd.ones((2,), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError):
        bool(a)
    # autograd is ported: backward of an array that no recorded
    # computation produced raises, marked for autograd or not
    with pytest.raises(mt.MXNetError, match="no computation recorded"):
        a.backward()
    a.attach_grad()
    with pytest.raises(mt.MXNetError, match="no computation recorded"):
        a.backward()


def test_asscalar_and_bfloat16_asnumpy():
    """numpy has no bfloat16: ``asnumpy`` widens to float32, exactly
    (the JAX package returns an ml_dtypes bfloat16 array)."""
    vals = np.linspace(-3, 3, 7).astype(np.float32)
    with mt.cpu():
        b = mt.nd.array(vals, dtype="bfloat16")
        assert b.dtype == torch.bfloat16
        host = b.asnumpy()
        assert mt.nd.array([2.5]).asscalar() == 2.5
    j = mx.nd.array(vals, dtype="bfloat16").asnumpy()
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, j.astype(np.float32))


def test_sampling_moments_and_determinism():
    """Moments within bounds at n = 10^5, and the same draws after the
    same seed: the streams are torch's, not the JAX package's."""
    n = 100000
    with mt.cpu():
        mt.random.seed(42)
        u = mt.nd.uniform(low=0, high=1, shape=(n,)).asnumpy()
        g = mt.random.normal(loc=5, scale=0.1, shape=(n,)).asnumpy()
        mt.random.seed(7)
        a = mt.nd.random_uniform(shape=(5,)).asnumpy()
        c = mt.nd.uniform(shape=(5,)).asnumpy()
        mt.random.seed(7)
        b = mt.nd._sample_uniform(shape=(5,)).asnumpy()
    assert u.dtype == np.float32 and u.min() >= 0 and u.max() <= 1
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.002
    assert abs(g.mean() - 5) < 0.002 and abs(g.std() - 0.1) < 0.002
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    mx.random.seed(42)
    ju = mx.nd.uniform(low=0, high=1, shape=(n,)).asnumpy()
    assert abs(ju.mean() - u.mean()) < 0.01


def test_gpu_default_raises_without_cuda(monkeypatch):
    """No CPU fallback: with no CUDA device and no CPU context, making an
    array raises; ``with mt.cpu():`` (or ``ctx=``) works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mt.current_context() == mt.gpu(0)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.uniform(shape=(2,))
    with mt.cpu() as ctx:
        assert mt.current_context() == ctx
        assert mt.cpu().default_ctx == ctx
        assert mt.nd.zeros((2,)).context == mt.cpu()
        assert mt.nd.arange(3).context == mt.cpu()
    assert mt.nd._ones(shape=(2,), ctx=mt.cpu()).context == mt.cpu()
    assert mt.current_context() == mt.gpu(0)


def test_every_registered_op_has_a_front_end():
    names = list(mt.op.registry._REGISTRY) + list(mt.op.registry._ALIASES)
    assert len(names) > 150
    for n in names:
        assert callable(getattr(mt.nd, n))
    with pytest.raises(AttributeError):
        mt.nd.no_such_op
    with pytest.raises(TypeError, match="positional"):
        mt.nd.relu(mt.nd.ones((2,), ctx=mt.cpu()), 3)
