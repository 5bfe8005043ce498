"""Testing harness (``mxnet_tpu/test_utils.py``, reference
``python/mxnet/test_utils.py``) on the port: finite-difference gradient
checks of a symbol against its backward (``check_numeric_gradient``),
forward and backward against closed-form expectations
(``check_symbolic_forward``/``check_symbolic_backward``), and the
comparison helpers they use.  Arrays land on the given context, else the
current one (``gpu(0)`` by default: CPU code runs under
``with mx.cpu():``)."""
from __future__ import annotations

import functools

import numpy as np

from .base import current_context
from .ndarray import NDArray, array


def default_dtype():
    return np.float32


_DEFAULT_ATOL = 1e-20
_DEFAULT_RTOL = 1e-5


def get_atol(atol=None):
    return _DEFAULT_ATOL if atol is None else atol


def get_rtol(rtol=None):
    return _DEFAULT_RTOL if rtol is None else rtol


def random_arrays(*shapes):
    """Generate random numpy arrays (reference ``test_utils.py:59``)."""
    arrays = [np.random.randn(*s).astype(default_dtype())
              for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Numpy reduce with mxnet axis/keepdims semantics
    (reference ``test_utils.py:68``)."""
    axes = ((axis,) if isinstance(axis, int)
            else tuple(axis) if axis is not None
            else tuple(range(dat.ndim)))
    axes = tuple(ax % dat.ndim for ax in axes)   # normalize negative axes
    ret = dat
    for ax in sorted(axes, reverse=True):     # high->low keeps indices valid
        ret = numpy_reduce_func(ret, axis=ax)
    if keepdims:
        kept = tuple(1 if i in axes else n for i, n in enumerate(dat.shape))
        ret = ret.reshape(kept)
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    """Locate the single worst tolerance violation between two arrays,
    measured in units of the allowed ``atol + rtol*|b|`` envelope:
    returns ``(index, ratio)`` where ratio > 1 means out of tolerance."""
    a, b = np.asarray(a), np.asarray(b)
    allowed = get_atol(atol) + get_rtol(rtol) * np.abs(b)
    ratio = np.abs(a - b) / (allowed + 1e-20)
    flat = int(np.argmax(ratio))
    return np.unravel_index(flat, ratio.shape), float(ratio.flat[flat])


def almost_equal(a, b, rtol=None, atol=None):
    return np.allclose(a, b, rtol=get_rtol(rtol), atol=get_atol(atol))


def same(a, b):
    return np.array_equal(a, b)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    rtol, atol = get_rtol(rtol), get_atol(atol)
    if not almost_equal(a, b, rtol, atol):
        index, worst = find_max_violation(a, b, rtol, atol)
        raise AssertionError(
            "Error %f exceeds tolerance rtol=%f, atol=%f.  Location of "
            "maximum error:%s, a=%f, b=%f"
            % (worst, rtol, atol, str(index),
               np.asarray(a)[index], np.asarray(b)[index]))


def _masked_nan_pair(a, b):
    """Copies of a/b with positions that are NaN in EITHER array zeroed
    in BOTH — shapes preserved, so violation indices stay meaningful."""
    a, b = np.array(a, copy=True), np.array(b, copy=True)
    either_nan = np.isnan(a) | np.isnan(b)
    a[either_nan] = b[either_nan] = 0
    return a, b


def almost_equal_ignore_nan(a, b, rtol=None, atol=None):
    return almost_equal(*_masked_nan_pair(a, b), rtol=rtol, atol=atol)


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None,
                                   names=("a", "b")):
    a, b = _masked_nan_pair(a, b)
    assert_almost_equal(a, b, rtol, atol, names)


def retry(n):
    """Retry decorator for stochastic tests (reference
    ``test_utils.py:203``): re-run on AssertionError up to ``n`` times."""
    assert n > 0

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            attempts_left = n
            while True:
                attempts_left -= 1
                try:
                    return f(*args, **kwargs)
                except AssertionError:
                    if not attempts_left:
                        raise
        return wrapper
    return decorate


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Forward a symbol on numpy inputs, return numpy outputs
    (reference ``test_utils.py:222``)."""
    ctx = ctx or current_context()
    inputs = {k: array(v) for k, v in inputs.items()}
    exe = sym.bind(ctx, args=inputs)
    exe.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in exe.outputs]
    if len(outputs) == 1:
        outputs = outputs[0]
    return outputs


def _named_ndarrays(values, names, ctx, what):
    """Normalize a dict-or-sequence of inputs to {name: NDArray} keyed by
    ``names``; dict keys must match exactly."""
    if not isinstance(values, dict):
        values = dict(zip(names, values))
    elif set(values) != set(names):
        raise ValueError("%s keys %s do not match symbol names %s"
                         % (what, sorted(values), sorted(names)))
    return {k: v if isinstance(v, NDArray) else array(np.asarray(v), ctx=ctx)
            for k, v in values.items()}


def _parse_location(sym, location, ctx):
    assert isinstance(location, (dict, list, tuple))
    return _named_ndarrays(location, sym.list_arguments(), ctx, "location")


def _parse_aux_states(sym, aux_states, ctx):
    if aux_states is None:
        return None
    return _named_ndarrays(aux_states, sym.list_auxiliary_states(), ctx,
                           "aux_states")


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central finite differences through a bound executor
    (reference ``test_utils.py:300-358``): d(sum(out0))/d(input element)
    for every element of every input."""
    def loss_at(name, values):
        executor.arg_dict[name][:] = values
        executor.forward(is_train=use_forward_train)
        return executor.outputs[0].asnumpy().sum()

    for name, values in location.items():
        executor.arg_dict[name][:] = values

    grads = {}
    for name, base in location.items():
        g = np.zeros(base.shape, dtype=np.float32)
        it = np.nditer(base, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            probe = base.copy()
            probe[idx] = base[idx] + eps / 2.0
            hi = loss_at(name, probe)
            probe[idx] = base[idx] - eps / 2.0
            lo = loss_at(name, probe)
            g[idx] = (hi - lo) / eps
            it.iternext()
        executor.arg_dict[name][:] = base    # restore before next input
        grads[name] = g
    return grads


def _normalize_grad_req(spec, names):
    """Normalize a grad-request spec (None / list / dict / str) to an
    ordered {name: req} over ``names``."""
    if spec is None:
        return {k: "write" for k in names}
    if isinstance(spec, str):
        return {k: spec for k in names}
    if isinstance(spec, (list, tuple)):
        vals = list(spec)
        if vals and vals[0] in ("write", "add", "null"):
            return dict(zip(names, vals))       # per-name req list
        return {k: "write" for k in vals}       # list of node names
    if isinstance(spec, dict):
        return dict(spec)
    raise ValueError("bad grad spec %r" % (spec,))


def _compare_grad(name, req, measured, expected, seeded, rtol, atol,
                  tag):
    """One grad comparison honoring the OpReqType semantics: 'write'
    compares directly, 'add' subtracts the seeded initial grad, 'null'
    demands the buffer was left untouched."""
    labels = ("%s_%s" % (tag, name), "BACKWARD_%s" % name)
    if req == "write":
        assert_almost_equal(expected, measured, rtol, atol, labels)
    elif req == "add":
        assert_almost_equal(expected, measured - seeded, rtol, atol,
                            labels)
    elif req == "null":
        assert_almost_equal(seeded, measured, rtol, atol, labels)
    else:
        raise ValueError("unknown grad_req %r for %s" % (req, name))


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Verify the symbolic backward against finite differences
    (reference ``test_utils.py:360-470``): attach a random positive
    projection head so every output element reaches the scalar loss,
    take one symbolic backward, then central-difference every input."""
    ctx = ctx or current_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    aux_npy = ({k: v.asnumpy() for k, v in aux_states.items()}
               if aux_states is not None else None)
    req = _normalize_grad_req(grad_nodes, sym.list_arguments())

    _, out_shapes, _ = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    from . import symbol as _sym_mod
    loss = _sym_mod.make_loss_internal(
        sym * _sym_mod.Variable("__random_proj"), name="__loss")
    location = dict(location,
                    __random_proj=array(
                        np.random.rand(*out_shapes[0]) + 0.1, ctx=ctx))

    seeded = {k: np.random.normal(0, 0.01, size=location[k].shape)
              for k in req}
    executor = loss.bind(
        ctx, args=location, grad_req=req, aux_states=aux_states,
        args_grad={k: array(v, ctx=ctx) for k, v in seeded.items()})
    executor.forward(is_train=True)
    executor.backward()
    measured = {k: executor.grad_dict[k].asnumpy() for k in req}

    fd = numeric_grad(executor, location_npy, aux_npy, eps=numeric_eps,
                      use_forward_train=use_forward_train)
    for name, r in req.items():
        if name == "__random_proj":
            continue
        # for 'null' the invariant is on the untouched buffer, so the
        # "expected" side is the fd grad only for write/add
        _compare_grad(name, r, measured[name],
                      fd[name] if r != "null" else None,
                      seeded[name], rtol, atol, "NUMERICAL")


def check_symbolic_forward(sym, location, expected, rtol=1E-4, atol=None,
                           aux_states=None, ctx=None):
    """Forward outputs must match closed-form numpy expectations
    (reference ``test_utils.py:473``)."""
    ctx = ctx or current_context()
    executor = sym.bind(
        ctx=ctx, args=_parse_location(sym=sym, location=location, ctx=ctx),
        aux_states=_parse_aux_states(sym=sym, aux_states=aux_states,
                                     ctx=ctx))
    executor.forward(is_train=False)
    outs = [o.asnumpy() for o in executor.outputs]
    names = sym.list_outputs()
    if isinstance(expected, dict):
        expected = [expected[k] for k in names]
    for name, want, got in zip(names, expected, outs):
        assert_almost_equal(want, got, rtol, atol,
                            ("EXPECTED_%s" % name, "FORWARD_%s" % name))


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """Backward gradients must match closed-form numpy expectations
    (reference ``test_utils.py:526``)."""
    ctx = ctx or current_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if not isinstance(expected, dict):
        expected = dict(zip(sym.list_arguments(), expected))
    req = _normalize_grad_req(grad_req, sym.list_arguments())

    seeded = {k: np.random.normal(size=v.shape)
              for k, v in expected.items()}
    executor = sym.bind(
        ctx=ctx, args=location, aux_states=aux_states, grad_req=req,
        args_grad={k: array(v, ctx=ctx) for k, v in seeded.items()})
    executor.forward(is_train=True)
    if isinstance(out_grads, dict):
        out_grads = [array(out_grads[k], ctx=ctx)
                     for k in sym.list_outputs()]
    elif isinstance(out_grads, (list, tuple)):
        out_grads = [array(v, ctx=ctx) if isinstance(v, np.ndarray) else v
                     for v in out_grads]
    # a bare NDArray (or None) passes straight through: backward accepts it
    executor.backward(out_grads)

    for name, want in expected.items():
        got = executor.grad_dict[name].asnumpy()
        r = req.get(name, "write")
        _compare_grad(name, r, got, want if r != "null" else None,
                      seeded[name], rtol, atol, "EXPECTED")
