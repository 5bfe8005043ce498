"""The port's ``WarpCTC`` (``op/ctc.py``) against the JAX package's on
the CPU and against a brute-force enumeration of every alignment (exact
for tiny T and V): the loss within 1e-5 relative of the enumeration, the
injected gradient within 1e-5 of the JAX op's largest magnitude
(``torch_parity.rel_err``) and within 1e-3/1e-4 of the enumeration's
finite differences, variable label lengths, the greedy decoder, and a
zero gradient for a label that cannot fit its frames."""
import itertools

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.op import ctc as jctc

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.op.ctc import (_ctc_grad, ctc_greedy_decode,
                                    ctc_loss_value)

from torch_parity import both, check_against_reference, rel_err


def _brute_force_nll(logits_tv, label):
    """-log P(label | x) by enumerating ALL alignments (T small)."""
    T, V = logits_tv.shape
    e = np.exp(logits_tv - logits_tv.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)
    target = [int(v) for v in label if v != 0]

    def collapse(path):
        out, prev = [], -1
        for k in path:
            if k != prev and k != 0:
                out.append(k)
            prev = k
        return out

    total = 0.0
    for path in itertools.product(range(V), repeat=T):
        if collapse(path) == target:
            p = 1.0
            for t, k in enumerate(path):
                p *= probs[t, k]
            total += p
    return -np.log(total)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("label", [[1, 2], [1, 1], [2, 0], [0, 0]])
def test_ctc_loss_matches_enumeration(label):
    T, V = 4, 3
    rng = np.random.RandomState(sum(label) * 7 + len(label))
    logits = rng.randn(T, V).astype("f")
    want = _brute_force_nll(logits, label)
    got = float(ctc_loss_value(_t(logits), _t([label]), T)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctc_grad_matches_numeric_and_the_jax_op():
    """The symbol's forward is the softmax; its backward equals the
    enumerated loss's finite differences and the JAX op's gradient."""
    T, V = 3, 3
    rng = np.random.RandomState(7)
    logits = rng.randn(T, V).astype("f") * 0.5
    label = np.asarray([[1, 2]], "f")
    port, _ = check_against_reference(
        lambda pkg: pkg.sym.WarpCTC(pkg.sym.Variable("data"),
                                    pkg.sym.Variable("label"),
                                    label_length=2, input_length=T),
        {"data": logits, "label": label}, tol=1e-5, grad_nodes=["data"])
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(port["outputs"][0],
                               e / e.sum(1, keepdims=True), rtol=1e-5)
    eps = 1e-3
    numeric = np.zeros_like(logits)
    for i in range(T):
        for j in range(V):
            up, dn = logits.copy(), logits.copy()
            up[i, j] += eps
            dn[i, j] -= eps
            numeric[i, j] = (_brute_force_nll(up, label[0]) -
                             _brute_force_nll(dn, label[0])) / (2 * eps)
    np.testing.assert_allclose(port["grads"]["data"], numeric, rtol=1e-3,
                               atol=1e-4)


def test_ctc_batch_variable_lengths():
    """Rows of different label lengths agree with the same rows alone,
    with the enumeration and with the JAX loss and gradient."""
    T, V, B = 5, 4, 3
    rng = np.random.RandomState(3)
    logits = rng.randn(T, B, V).astype("f")
    labels = np.asarray([[1, 2, 3], [2, 0, 0], [3, 1, 0]], "f")
    flat = logits.reshape(T * B, V)
    batched = ctc_loss_value(_t(flat), _t(labels), T).numpy()
    want = np.asarray(jax.jit(jctc.ctc_loss_value, static_argnums=2)(
        flat, labels, T))
    np.testing.assert_allclose(batched, want, rtol=1e-5)
    for b in range(B):
        single = ctc_loss_value(_t(logits[:, b]), _t(labels[b:b + 1]), T)
        np.testing.assert_allclose(batched[b], float(single[0]), rtol=1e-5)
        np.testing.assert_allclose(batched[b],
                                   _brute_force_nll(logits[:, b], labels[b]),
                                   rtol=1e-4)
    (got, _, ggrad), (w, _, wgrad) = both(
        "WarpCTC", {"label_length": 3, "input_length": T}, [flat, labels],
        jit=True)
    assert rel_err(got[0], w[0]) <= 1e-5
    assert rel_err(ggrad[0], wgrad[0]) <= 1e-5


def test_ctc_greedy_decode():
    T, B, V = 6, 2, 4
    probs = np.zeros((T, B, V), "f")
    seq0 = [0, 1, 1, 0, 2, 2]
    seq1 = [3, 3, 0, 3, 0, 0]
    for t in range(T):
        probs[t, 0, seq0[t]] = 1
        probs[t, 1, seq1[t]] = 1
    flat = probs.reshape(T * B, V)
    assert ctc_greedy_decode(flat, T) == [[1, 2], [3, 3]]
    with mt.cpu():
        assert ctc_greedy_decode(mt.nd.array(flat), T) == [[1, 2], [3, 3]]


def test_ctc_infeasible_label_zero_grad():
    """A label that cannot fit its frames ([1,1,1] needs T >= 5) gets an
    infinite loss and a zero gradient row; a feasible row beside it
    keeps its gradient, as in the JAX package."""
    T, V = 4, 3
    rng = np.random.RandomState(1)
    logits = rng.randn(T, V).astype("f")
    nll = ctc_loss_value(_t(logits), _t([[1, 1, 1]]), T).numpy()
    assert np.isinf(nll[0])
    grad = _ctc_grad(_t(logits), _t([[1, 1, 1]]), T).numpy()
    np.testing.assert_array_equal(grad, np.zeros_like(grad))
    logits2 = rng.randn(T * 2, V).astype("f")
    labels = np.asarray([[1, 1, 1], [1, 2, 0]], "f")
    grad2 = _ctc_grad(_t(logits2), _t(labels), T).numpy()
    want = np.asarray(jax.jit(jctc._ctc_grad, static_argnums=(2, 3))(
        logits2, labels, 3, T))
    assert rel_err(grad2, want) <= 1e-5
    g = grad2.reshape(T, 2, V)
    np.testing.assert_array_equal(g[:, 0], np.zeros((T, V)))
    assert 0.01 < np.abs(g[:, 1]).max() <= 1.0 + 1e-5
