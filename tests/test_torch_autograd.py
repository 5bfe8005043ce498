"""The port's imperative autograd: the analogs of ``tests/test_autograd.py``
on ``mt.cpu()`` NDArrays, and a recorded attention call whose gradients
match the JAX package's ``jax.vjp`` of ``flash_attention``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.op.pallas import flash_attention as jax_flash_attention

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd


def _arr(x):
    return mt.nd.array(np.asarray(x, dtype=np.float32), ctx=mt.cpu())


def test_mark_variables_backward():
    x = _arr(np.random.RandomState(0).randn(3, 4))
    x.attach_grad()
    with autograd.record():
        y = x * x + 2 * x
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy() + 2,
                               atol=1e-5)


def test_training_mode():
    assert not autograd.is_training()
    with autograd.record(train_mode=True):
        assert autograd.is_training() and autograd.is_recording()
    assert not autograd.is_recording()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert autograd.set_training(True) is False
    assert autograd.set_training(False) is True


def test_chain_ops():
    x = _arr(np.abs(np.random.RandomState(1).randn(4)) + 0.5)
    x.attach_grad()
    with autograd.record():
        y = mt.nd.log(mt.nd.sqrt(x))
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 0.5 / x.asnumpy(), atol=1e-5)


def test_multiple_inputs_and_grad_req_add():
    rng = np.random.RandomState(2)
    a, b = _arr(rng.randn(3)), _arr(rng.randn(3))
    a.attach_grad()
    b.attach_grad(grad_req="add")
    for _ in range(2):
        with autograd.record():
            c = a * b
        c.backward()
    np.testing.assert_allclose(a.grad.asnumpy(), b.asnumpy(), atol=1e-6)
    np.testing.assert_allclose(b.grad.asnumpy(), 2 * a.asnumpy(), atol=1e-6)


def test_out_grad():
    x = mt.nd.ones((3,), ctx=mt.cpu())
    x.attach_grad()
    with autograd.record():
        y = x * 4
    y.backward(_arr([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(x.grad.asnumpy(), [4, 8, 12])


def test_pause():
    x = mt.nd.ones((2,), ctx=mt.cpu())
    x.attach_grad()
    with autograd.record():
        y = x * 2
        with autograd.pause():
            z = y * 3           # not recorded
        w = y + 1
    w.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2, 2])
    with pytest.raises(mt.MXNetError, match="no computation recorded"):
        z.backward()


def test_grad_returns_new_arrays():
    x = _arr([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
    (g,) = autograd.grad([y], [x])
    np.testing.assert_allclose(g.asnumpy(), [2, 4])
    assert not x.grad.asnumpy().any()     # no gradient array written


def test_recorded_attention_matches_jax_vjp():
    """``mt.nd._contrib_DotProductAttention`` recorded and backpropagated:
    on the card this is the path of B2's bfloat16 kernel; here it runs
    the plain versions, held against ``jax.vjp`` (float32, the tolerance
    of ``test_flash_gradients_match_reference``)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.normal(0, 1, (2, 24, 2, 8)).astype("f") for _ in range(3))
    g = rng.normal(0, 1, (2, 24, 2, 8)).astype("f")
    arrs = [_arr(x) for x in (q, k, v)]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = mt.nd._contrib_DotProductAttention(*arrs, causal=True)
    out.backward(_arr(g))
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, causal=True,
                                            interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    for a, want in zip(arrs, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
