"""The rest of ``op/tensor.py`` and ``op/init_ops.py``'s samplers on the
port against the JAX package on the CPU.

Layout, ordering and indexing ops: the same numpy inputs (from a seed)
through both op bodies, forward and backward with the same random head
gradients (``jax.vjp`` beside ``torch.autograd.grad``), and both shape
inferences; every array within 1e-6 of the JAX side's largest magnitude
(these ops move values; only a sum of repeated gradients rounds).  Ties
are included: a stable sort keeps tied entries in index order, as
``lax.top_k`` and ``jnp.argsort`` do.

Samplers draw from the port's generator (streams differ by design): each
is held by its mean and variance on 200,000 draws (within 4 standard
errors of the distribution's), by its support, and by a bitwise repeat
per seed."""
import numpy as np
import pytest
import torch

from mxnet_tpu.op import registry as jreg
from mxnet_tpu_torch.op import registry as treg
import mxnet_tpu_torch as mt

from torch_parity import both, assert_close

TOL = 1e-6


def _normal(*shape):
    return lambda rng: rng.standard_normal(shape).astype(np.float32)


def _ties(*shape):
    """Values on a grid of 4, so rows hold ties."""
    return lambda rng: rng.integers(0, 4, shape).astype(np.float32)


def _ints(lo, hi, *shape):
    return lambda rng: rng.integers(lo, hi, shape).astype(np.float32)


CASES = [
    ("swapaxis", "SwapAxis", {"dim1": 0, "dim2": 2}, [_normal(2, 3, 4)]),
    ("swapaxes_negative", "swapaxes", {"dim1": -1, "dim2": 1},
     [_normal(2, 3, 4)]),
    ("slice", "slice", {"begin": (0, 1, 1), "end": (2, 3, 4)},
     [_normal(3, 4, 5)]),
    ("tile", "tile", {"reps": (2, 1, 3)}, [_normal(2, 3)]),
    ("repeat_flat", "repeat", {"repeats": 2}, [_normal(2, 3)]),
    ("repeat_axis", "repeat", {"repeats": 3, "axis": 1}, [_normal(2, 3)]),
    ("reverse", "reverse", {"axis": 1}, [_normal(2, 3, 4)]),
    ("flip_axes", "flip", {"axis": (0, 2)}, [_normal(2, 3, 4)]),
    ("broadcast_axis", "broadcast_axis", {"axis": (0, 2), "size": (3, 4)},
     [_normal(1, 2, 1)]),
    ("broadcast_axes", "broadcast_axes", {"axis": 1, "size": 5},
     [_normal(2, 1)]),
    ("pad_constant", "Pad", {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                             "constant_value": 1.5}, [_normal(1, 2, 3, 4)]),
    ("pad_edge", "Pad", {"pad_width": (0, 0, 0, 0, 2, 1, 1, 3),
                         "mode": "edge"}, [_normal(1, 2, 3, 4)]),
    ("pad_reflect", "pad", {"pad_width": (0, 0, 0, 0, 2, 1, 1, 3),
                            "mode": "reflect"}, [_normal(1, 2, 3, 4)]),
    ("pad_reflect_5d", "Pad", {"pad_width": (0, 0, 0, 0, 1, 1, 2, 0, 0, 2),
                               "mode": "reflect"}, [_normal(1, 1, 3, 4, 3)]),
    ("argmax_channel", "argmax_channel", {}, [_normal(3, 4, 2)]),
    ("topk_indices", "topk", {"k": 2}, [_ties(3, 5)]),
    ("topk_value_ascend", "topk", {"k": 3, "ret_typ": "value",
                                   "is_ascend": True}, [_ties(3, 5)]),
    ("topk_both_axis0", "topk", {"k": 2, "ret_typ": "both", "axis": 0},
     [_ties(4, 3)]),
    ("topk_mask", "topk", {"k": 2, "ret_typ": "mask"}, [_ties(2, 3, 4)]),
    ("sort", "sort", {}, [_ties(3, 5)]),
    ("sort_descending_axis0", "sort", {"axis": 0, "is_ascend": False},
     [_normal(4, 3)]),
    ("argsort_ties", "argsort", {}, [_ties(3, 6)]),
    ("argsort_descending", "argsort", {"is_ascend": False, "axis": 0},
     [_ties(5, 3)]),
    ("take_clip", "take", {}, [_normal(5, 3), _ints(-2, 8, 2, 4)]),
    ("take_wrap_axis1", "take", {"axis": 1, "mode": "wrap"},
     [_normal(2, 4, 3), _ints(-6, 9, 5)]),
    ("take_raise_clips", "take", {"mode": "raise"},
     [_normal(4, 2), _ints(0, 6, 3)]),
    ("batch_take", "batch_take", {}, [_normal(4, 5), _ints(0, 5, 4)]),
    ("pick", "pick", {}, [_normal(3, 4), _ints(0, 4, 3)]),
    ("pick_axis0_keepdims", "pick", {"axis": 0, "keepdims": True},
     [_normal(3, 4, 2), _ints(0, 3, 4, 2)]),
    ("block_grad", "BlockGrad", {}, [_normal(2, 3)]),
    ("stop_gradient", "stop_gradient", {}, [_normal(2, 3)]),
    ("make_loss_internal", "make_loss_internal", {}, [_normal(2, 3)]),
    ("identity_with_attr_like_rhs", "_identity_with_attr_like_rhs", {},
     [_normal(2, 3), _normal(2, 3)]),
    ("cross_device_copy", "_CrossDeviceCopy", {}, [_normal(2, 3)]),
]


@pytest.mark.parametrize("name,op,params,makers", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(name, op, params, makers):
    rng = np.random.default_rng(0)
    ins = [m(rng) for m in makers]
    (g_out, _, g_grads), (w_out, _, w_grads) = both(op, params, ins)
    assert_close(g_out, w_out, TOL, name + " outputs")
    assert_close(g_grads, w_grads, TOL, name + " gradients")
    j_op, t_op = jreg.get(op), treg.get(op)
    shapes = [a.shape for a in ins]
    _, j_out, _ = j_op.infer_shape_generic(j_op.parse_params(dict(params)),
                                           shapes)
    _, t_out, _ = t_op.infer_shape_generic(t_op.parse_params(dict(params)),
                                           shapes)
    assert [tuple(s) for s in t_out] == [tuple(s) for s in j_out] \
        == [o.shape for o in g_out]


def test_jax_topk_mask_off_the_last_axis_is_scrambled():
    """JAX-package defect: ``topk(ret_typ="mask")`` along an axis other
    than the last reshapes the indices after moving them back to that
    axis (``mxnet_tpu/op/tensor.py`` ``_topk``), so its mask marks other
    positions.  The port marks the ``k`` largest along the axis (numpy's
    stable descending order), and on the last axis equals the JAX op."""
    x = np.random.default_rng(0).integers(0, 4, (2, 4, 3)).astype(np.float32)
    kw = {"k": 2, "ret_typ": "mask", "axis": 1}
    (g_out, _, _), (w_out, _, _) = both("topk", kw, [x])
    order = np.argsort(-x, axis=1, kind="stable")[:, :2]
    want = np.zeros_like(x)
    np.put_along_axis(want, order, 1.0, axis=1)
    np.testing.assert_array_equal(g_out[0], want)
    assert (w_out[0] != want).any()
    np.testing.assert_array_equal(g_out[0].sum(1), 2.0)


def test_views_stay_views():
    """SwapAxis, slice and broadcast_axis read their input in place."""
    x = torch.arange(12.0).reshape(1, 3, 4)
    for op, kw in (("SwapAxis", {"dim1": 0, "dim2": 2}),
                   ("slice", {"begin": (0, 1, 0), "end": (1, 3, 2)}),
                   ("broadcast_axis", {"axis": 0, "size": 5})):
        o = treg.get(op)
        (out,), _ = o.apply(o.parse_params(dict(kw)), treg.OpContext(), x)
        assert out.untyped_storage().data_ptr() \
            == x.untyped_storage().data_ptr(), op


# (op, params, mean, variance, support check)
SAMPLERS = [
    ("_sample_gamma", {"alpha": 2.0, "beta": 1.5}, 3.0, 4.5,
     lambda o: (o > 0).all()),
    ("random_gamma", {"alpha": 0.4, "beta": 2.0}, 0.8, 1.6,
     lambda o: (o >= 0).all()),
    ("_sample_exponential", {"lam": 2.0}, 0.5, 0.25,
     lambda o: (o >= 0).all()),
    ("exponential", {"lam": 0.5}, 2.0, 4.0, lambda o: (o >= 0).all()),
    ("_sample_poisson", {"lam": 3.0}, 3.0, 3.0,
     lambda o: (o >= 0).all() and (o == np.round(o)).all()),
    ("poisson", {"lam": 0.7}, 0.7, 0.7, lambda o: (o >= 0).all()),
    ("_sample_negbinomial", {"k": 3, "p": 0.4}, 4.5, 11.25,
     lambda o: (o >= 0).all() and (o == np.round(o)).all()),
    ("negative_binomial", {"k": 1, "p": 0.5}, 1.0, 2.0,
     lambda o: (o >= 0).all()),
    ("_sample_gennegbinomial", {"mu": 2.0, "alpha": 0.5}, 2.0, 4.0,
     lambda o: (o >= 0).all() and (o == np.round(o)).all()),
    ("generalized_negative_binomial", {"mu": 5.0, "alpha": 0.2}, 5.0, 10.0,
     lambda o: (o >= 0).all()),
]
N_DRAWS = 200_000


def _draw(op, params, seed, shape=(N_DRAWS,)):
    o = treg.get(op)
    p = o.parse_params(dict(params, shape=shape))
    gen = torch.Generator().manual_seed(seed)
    (out,), _ = o.apply(p, treg.OpContext(rng=gen))
    return out.numpy()


@pytest.mark.parametrize("op,params,mean,var,support", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_and_repeat_per_seed(op, params, mean, var,
                                             support):
    out = _draw(op, params, 7)
    assert out.dtype == np.float32 and out.shape == (N_DRAWS,)
    assert support(out)
    se = np.sqrt(var / N_DRAWS)
    assert abs(out.mean() - mean) < 4 * se, (out.mean(), mean)
    assert abs(out.var() - var) < 0.05 * var, (out.var(), var)
    np.testing.assert_array_equal(out, _draw(op, params, 7))
    assert (out != _draw(op, params, 8)).any()


def test_every_sampler_name_of_the_jax_registry():
    """The samplers under every name the JAX registry gives them, with
    the shape and dtype their params ask for, also through ``mt.nd`` and
    the shape inference."""
    names = [n for n in set(jreg._REGISTRY) | set(jreg._ALIASES)
             if jreg.get(n).name in ("_sample_gamma", "_sample_exponential",
                                     "_sample_poisson",
                                     "_sample_negbinomial",
                                     "_sample_gennegbinomial")]
    assert len(names) == 14
    for n in names:
        assert treg.get(n).name == jreg.get(n).name, n
        op = treg.get(n)
        p = op.parse_params({"shape": (3, 2), "dtype": "float16"})
        _, out, _ = op.infer_shape_generic(p, [])
        assert [tuple(s) for s in out] == [(3, 2)]
        with mt.cpu():
            arr = getattr(mt.nd, n)(shape=(3, 2), dtype="float16")
        assert arr.shape == (3, 2) and arr.dtype == torch.float16


@pytest.mark.parametrize("op,params", [
    ("sort", {"axis": None}), ("sort", {"axis": None, "is_ascend": False}),
    ("argsort", {"axis": None}),
    ("argsort", {"axis": None, "is_ascend": False}),
    ("topk", {"axis": None, "k": 2}),
    ("topk", {"axis": None, "k": 2, "ret_typ": "value"})])
def test_ordering_with_axis_none_matches_jax(op, params):
    """``axis=None``: sort and argsort order the flattened array, as
    ``jnp.sort``/``jnp.argsort`` do; topk takes the last axis, as the JAX
    op does.  Exact: sorted values and integer indices, ties included."""
    x = np.random.default_rng(5).integers(0, 6, (2, 4, 3)) \
        .astype(np.float32)
    (got, _, _), (want, _, _) = both(op, params, [x], is_train=False)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sort_with_axis_none_infers_a_flat_shape():
    import mxnet_tpu as mx
    for pkg in (mx, mt):
        a = pkg.sym.Variable("a")
        for op in (pkg.sym.sort, pkg.sym.argsort):
            _, out, _ = op(a, axis=None).infer_shape(a=(2, 5))
            assert out == [(10,)], (pkg.__name__, out)


@pytest.mark.parametrize("index", [(-1, 5, 2), (-5, 4, 3)])
def test_pick_past_the_axis_fills_as_the_jax_package(index):
    """``pick`` reads its indices as ``jnp.take_along_axis`` does: an
    index in ``[-n, n)`` wraps, any other fills its place with NaN (the
    type's lowest value for a signed integer type), with a zero
    gradient there."""
    import mxnet_tpu as mx
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.asarray(index, np.float32)
    (got, _, ggrad), (want, _, wgrad) = both(
        "pick", {"axis": 1}, [a, idx], is_train=True)
    expect = {(-1, 5, 2): [3, np.nan, 10], (-5, 4, 3): [np.nan, np.nan, 11]}
    np.testing.assert_array_equal(got[0], np.asarray(expect[index], "f"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(ggrad[0], wgrad[0])
    assert not ggrad[0][np.isnan(got[0])].any()
    ai = np.arange(12, dtype=np.int32).reshape(3, 4)
    ii = np.asarray(index, np.int32)
    with mt.cpu():
        gi = mt.nd.pick(mt.nd.array(ai), mt.nd.array(ii), axis=1).asnumpy()
    wi = mx.nd.pick(mx.nd.array(ai), mx.nd.array(ii), axis=1).asnumpy()
    np.testing.assert_array_equal(gi, wi)
