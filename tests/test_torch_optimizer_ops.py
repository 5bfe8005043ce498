"""The port's optimizer update ops (``op/optimizer_op.py``) against the
JAX package's, on the CPU: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update`` through
``mt.nd`` beside ``mx.nd``, with and without gradient clipping, the same
numpy inputs from a seed.

Tolerance: float32 on both sides, the same operations in the same order;
each result within 1e-6 of the JAX op's by relative norm (measured:
~6e-8; a wrong coefficient is off by 1e-3 or more)."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

REL_TOL = 1e-6
SHAPE = (6, 7)
# op, its states, its own parameters
OPS = [
    ("sgd_update", 0, {}),
    ("sgd_mom_update", 1, dict(momentum=0.9)),
    ("adam_update", 2, dict(beta1=0.8, beta2=0.99, epsilon=1e-6, t=3)),
    ("rmsprop_update", 1, dict(gamma1=0.9, epsilon=1e-6, clip_weights=0.9)),
    ("rmspropalex_update", 3, dict(gamma1=0.9, gamma2=0.8, epsilon=1e-4)),
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _inputs(n_states, seed=0):
    rng = np.random.RandomState(seed)
    weight, grad = rng.randn(*SHAPE).astype("f"), 3 * rng.randn(*SHAPE)
    states = [np.abs(rng.randn(*SHAPE)).astype("f") for _ in range(n_states)]
    if n_states == 3:       # centered: n above g-bar squared
        states[0] += states[1] ** 2
    return [weight, grad.astype("f")] + states


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("name,n_states,kw", OPS, ids=[o[0] for o in OPS])
def test_update_op_matches_the_jax_package(name, n_states, kw, clip):
    kw = dict(kw, lr=0.1, wd=0.01, rescale_grad=0.7)
    if clip is not None:
        kw["clip_gradient"] = clip
    ins = _inputs(n_states)
    want = getattr(mx.nd, name)(*[mx.nd.array(a) for a in ins], **kw)
    got = getattr(mt.nd, name)(*[mt.nd.array(a, ctx=mt.cpu()) for a in ins],
                               **kw)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want) == 1 + n_states
    for g, w in zip(got, want):
        assert _rel(g.asnumpy(), w.asnumpy()) < REL_TOL
    assert not np.array_equal(got[0].asnumpy(), ins[0])


def test_update_ops_write_back_in_place_and_exist_as_symbols():
    """``out=`` writes the results into the given arrays, as the
    reference's in-place calls do; each op is a symbol too."""
    w, g, mom = (mt.nd.array(a, ctx=mt.cpu()) for a in _inputs(1))
    want = mt.nd.sgd_mom_update(w.copy(), g, mom.copy(), lr=0.1,
                                momentum=0.9)
    mt.nd.sgd_mom_update(w, g, mom, out=[w, mom], lr=0.1, momentum=0.9)
    np.testing.assert_array_equal(w.asnumpy(), want[0].asnumpy())
    np.testing.assert_array_equal(mom.asnumpy(), want[1].asnumpy())
    sym = mt.sym.adam_update(mt.sym.Variable("weight"),
                             mt.sym.Variable("grad"), mt.sym.Variable("mean"),
                             mt.sym.Variable("var"), lr=0.1)
    assert sym.list_arguments() == ["weight", "grad", "mean", "var"]
    assert len(sym.list_outputs()) == 3


def test_rmspropalex_clips_weights_as_the_reference_does():
    """``clip_weights`` bounds centered RMSProp's new weight, as the
    reference's op does; the JAX op ignores it (ROADMAP §C)."""
    ins = _inputs(3)
    kw = dict(lr=0.5, gamma1=0.9, gamma2=0.8, epsilon=1e-4)
    free = mt.nd.rmspropalex_update(
        *[mt.nd.array(a, ctx=mt.cpu()) for a in ins], **kw)[0].asnumpy()
    clipped = mt.nd.rmspropalex_update(
        *[mt.nd.array(a, ctx=mt.cpu()) for a in ins], clip_weights=0.25,
        **kw)[0].asnumpy()
    assert np.abs(free).max() > 0.25
    np.testing.assert_array_equal(clipped, np.clip(free, -0.25, 0.25))
    jax_clipped = mx.nd.rmspropalex_update(
        *[mx.nd.array(a) for a in ins], clip_weights=0.25, **kw)[0].asnumpy()
    assert np.abs(jax_clipped).max() > 0.25
