"""The port's flash-attention forward against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs
in Pallas interpret mode as ``tests/test_attention.py`` runs it.  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.op.pallas import flash_attention, flash_attention_reference
from mxnet_tpu.op.pallas.flash_attention import _fwd_impl
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.op.kernels.flash_attention import (
    _check_kernel_args, attention_reference, flash_attention_fwd)

# both sides compute in float32 and sum in another order: the tolerance
# tests/test_attention.py holds the Pallas kernel to
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, tq, tkv, h, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (b, tq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, tkv, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, tkv, h, d)).astype(np.float32))


def _fold(x):
    """[b, t, h, d] -> [b*h, t, d], the JAX kernel's layout."""
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


@pytest.mark.parametrize("tq,tkv,causal", [
    (64, 64, False), (64, 64, True),
    (37, 53, False),          # ragged
    (100, 100, True),         # ragged + causal
    (32, 128, True),          # t_q != t_kv: pins the top-left causal mask
])
def test_forward_and_lse_match_pallas(tq, tkv, causal):
    q, k, v = _qkv(0, 2, tq, tkv, 3, 16)
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert o.dtype == torch.float32 and o.shape == (2, tq, 3, 16)
    assert lse.dtype == torch.float32 and lse.shape == (2 * 3, tq)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = flash_attention(jq, jk, jv, causal=causal, interpret=True)
    oracle = flash_attention_reference(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(oracle), **F32_TOL)
    _, jlse = _fwd_impl(_fold(q), _fold(k), _fold(v), causal,
                        1.0 / math.sqrt(16), 128, 128, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :tq],
                               **F32_TOL)


def test_bf16_io_matches_pallas():
    q, k, v = (x.astype(jnp.bfloat16) for x in
               (jnp.asarray(a) for a in _qkv(2, 1, 64, 64, 2, 16)))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  .to(torch.bfloat16) for x in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    pallas = flash_attention(q, k, v, causal=True, interpret=True)
    # the Pallas kernel rounds P to bf16 before P V and both round O to
    # bf16: one bf16 ulp near |o| ~ 1 is 2^-7
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=2e-2, atol=2e-2)
    # bf16 products are exact in f32, so lse agrees to f32 rounding
    _, jlse = _fwd_impl(_fold(q), _fold(k), _fold(v), True,
                        1.0 / math.sqrt(16), 128, 128, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :64],
                               **F32_TOL)


def test_cpu_and_meta_never_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 8, 8, 1, 16))
    before = flash_attention_fwd.launches
    flash_attention_fwd(q, k, v)
    o, lse = flash_attention_fwd(*(x.to("meta") for x in (q, k, v)),
                                 causal=True)
    assert o.device.type == "meta" and o.shape == (1, 8, 1, 16)
    assert lse.shape == (1, 8)
    assert flash_attention_fwd.launches == before


def test_no_keys_gives_zero_output_and_neg_inf_lse():
    q = torch.ones(1, 4, 2, 16)
    kv = torch.ones(1, 0, 2, 16)
    o, lse = attention_reference(q, kv, kv, causal=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()


def test_strided_qkv_views_are_kernel_inputs():
    """The attention block's q, k, v are slices of one fused projection:
    the kernel takes them as they are, without a copy."""
    qkv = torch.zeros(2, 32, 3, 4, 16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    assert not q.is_contiguous()
    _check_kernel_args(q, k, v)


@pytest.mark.parametrize("case", ["float16", "head_dim_256", "strided_dim"])
def test_kernel_refuses_what_it_cannot_run(case):
    q = torch.zeros(1, 8, 2, 32)
    if case == "float16":
        q = q.half()
    elif case == "head_dim_256":
        q = torch.zeros(1, 8, 2, 256)
    else:
        q = torch.zeros(1, 8, 64, 2).transpose(2, 3)
    with pytest.raises(MXNetError):
        _check_kernel_args(q, q, q)


def test_mismatched_shapes_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(MXNetError):
        flash_attention_fwd(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
