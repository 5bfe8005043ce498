"""The port's flash-attention backward (B2) against the JAX package's.

On the CPU the port's wrapper runs its plain version, and
``FlashAttention`` runs both plain versions; the JAX side is ``jax.vjp``
of ``flash_attention`` in Pallas interpret mode, as
``tests/test_attention.py`` runs it, and ``_bwd_impl`` itself for
bfloat16.  The CUDA kernel is held against the plain version on the card
by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.op.pallas import flash_attention as jax_flash_attention
from mxnet_tpu.op.pallas.flash_attention import _bwd_impl
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.op.kernels import flash_attention as fa

# tests/test_attention.py's test_flash_gradients_match_reference: both
# sides float32, sums in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16: both round q*scale, P and dS to bfloat16 at the same places
# and sum the same products in float32 over blocks of 128 keys, so the
# outputs agree to within one bfloat16 ulp (2^-8 relative) where a sum
# lands on a rounding boundary
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


def _inputs(seed, b, tq, tkv, h, d):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tkv, h, d), (b, tkv, h, d),
                      (b, tq, h, d))]


@pytest.mark.parametrize("tq,tkv,causal", [
    (37, 53, False),          # ragged
    (100, 100, True),         # ragged + causal
    (32, 128, True),          # cross-shaped: the top-left causal mask
    (128, 32, True),
    (1, 1, True),             # t = 1
    (1, 1, False),
])
def test_gradients_match_jax_vjp(tq, tkv, causal):
    q, k, v, g = _inputs(0, 2, tq, tkv, 3, 16)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal, None)
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, **GRAD_TOL)

    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal)
    plain = fa.attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), o, lse,
        torch.from_numpy(g), causal=causal)
    for x, w in zip(plain, want):
        np.testing.assert_allclose(x.numpy(), w, **GRAD_TOL)


def _fold(x):
    """[b, t, h, d] torch -> [b*h, t, d] jax in the same dtype, the JAX
    kernel's layout."""
    b, t, h, d = x.shape
    a = jnp.asarray(x.float().numpy())
    if x.dtype == torch.bfloat16:
        a = a.astype(jnp.bfloat16)
    return a.transpose(0, 2, 1, 3).reshape(b * h, t, d)


@pytest.mark.parametrize("tq,tkv,causal", [
    (37, 53, False), (100, 100, True), (32, 128, True)])
def test_bfloat16_matches_bwd_impl(tq, tkv, causal):
    b, h, d = 2, 3, 16
    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in _inputs(1, b, tq, tkv, h, d))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    grads = fa.attention_bwd_reference(q, k, v, o, lse, g, causal=causal)
    want = _bwd_impl(_fold(q), _fold(k), _fold(v), _fold(o),
                     jnp.asarray(lse.numpy()), _fold(g), causal,
                     1.0 / math.sqrt(d), 128)
    for x, w, t in zip(grads, want, (tq, tkv, tkv)):
        assert x.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32)).reshape(b, h, t, d) \
            .transpose(0, 2, 1, 3)
        np.testing.assert_allclose(x.float().numpy(), w, **BF16_TOL)


def test_dead_row_gets_no_gradient():
    """A row whose lse is -inf (no key to see) gets P = 0, so nothing
    flows through it, as in ``_bwd_impl``."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 1, 4, 6, 2, 8))
    o, lse = fa.flash_attention_fwd(q, k, v)
    lse[:, 1] = float("-inf")
    dq, dk, dv = fa.attention_bwd_reference(q, k, v, o, lse, g)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert (dq[:, 1] == 0).all()
    g2 = g.clone()
    g2[:, 1] = 0
    _, _, dv2 = fa.attention_bwd_reference(q, k, v, o, lse, g2)
    torch.testing.assert_close(dv, dv2)


def test_wrapper_checks_and_plain_route():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, 1, 8, 8, 2, 16))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fa.reset_counts()
    dq, _, _ = fa.flash_attention_bwd(q, k, v, o, lse, g, causal=True)
    assert dq.shape == q.shape and dq.dtype == torch.float32
    # the plain version on the CPU is not a launch
    assert sum(fa.flash_attention_bwd.kernel_launches.values()) == 0
    assert set(fa.flash_attention_bwd.kernel_launches) == {
        "flash_attention_bwd_f32", "flash_attention_bwd_bf16"}
    with pytest.raises(MXNetError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :4], g)
    with pytest.raises(MXNetError, match="q's shape"):
        fa.flash_attention_bwd(q, k, v, o[:, :4], lse, g)
    meta = [x.to("meta") for x in (q, k, v, o, lse, g)]
    with pytest.raises(MXNetError, match="cuda or cpu"):
        fa.flash_attention_bwd(*meta)
    assert fa.LIBRARIES[-1].source.name == "flash_attention_bwd.cu"


def test_autograd_function_under_no_grad_is_the_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 2, 9, 9, 2, 8))
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, True, None)
    torch.testing.assert_close(out, fa.attention_reference(q, k, v, True)[0])
