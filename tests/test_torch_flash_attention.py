"""The port's flash-attention forward against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs
in Pallas interpret mode as ``tests/test_attention.py`` runs it.  The
wrapper's decisions (which kernel a dtype takes, which inputs it copies
first) are checked here on CPU and meta tensors.  The CUDA kernels
themselves are held against the plain version on the card by
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
    _padded_copy, attention_reference, flash_attention_fwd, kernel_route)

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
    by_kernel = dict(flash_attention_fwd.kernel_launches)
    copies = flash_attention_fwd.padded_copies
    flash_attention_fwd(q, k, v)
    for dtype in (torch.float32, torch.bfloat16):
        o, lse = flash_attention_fwd(
            *(x.to("meta", dtype) for x in (q, k, v)), causal=True)
        assert o.device.type == "meta" and o.shape == (1, 8, 1, 16)
        assert o.dtype == dtype and lse.shape == (1, 8)
    assert flash_attention_fwd.launches == before
    assert flash_attention_fwd.kernel_launches == by_kernel
    assert flash_attention_fwd.padded_copies == copies


def test_no_keys_gives_zero_output_and_neg_inf_lse():
    q = torch.ones(1, 4, 2, 16)
    kv = torch.ones(1, 0, 2, 16)
    o, lse = attention_reference(q, kv, kv, causal=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()


def test_strided_qkv_views_are_kernel_inputs():
    """The attention block's q, k, v are slices of one fused projection:
    each kernel takes them as they are, without a copy, at the serving
    head dim and in either dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        for device in ("cpu", "meta"):
            qkv = torch.zeros(2, 32, 3, 12, 64, dtype=dtype, device=device)
            q, k, v = (qkv[:, :, i] for i in range(3))
            assert not q.is_contiguous()
            assert kernel_route(q, k, v)[1] == (False, False, False)


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "flash_attention_fwd_f32"),
    (torch.bfloat16, "flash_attention_fwd_bf16"),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dtype_picks_the_kernel(dtype, kernel, device):
    q = torch.zeros(1, 8, 2, 64, dtype=dtype, device=device)
    assert kernel_route(q, q, q) == (kernel, (False, False, False))


def _offset(shape, dtype, elems):
    """A contiguous tensor whose data starts ``elems`` elements into its
    storage."""
    return torch.zeros(math.prod(shape) + elems, dtype=dtype)[elems:].view(
        shape)


# (case, dtype, inputs -> (q, k, v), the copies the route makes)
_COPY_CASES = [
    # head_dim 20: a bf16 head stride of 40 bytes, a f32 one of 80
    ("head_dim_20", torch.bfloat16,
     lambda dt: [torch.zeros(1, 8, 3, 20, dtype=dt)] * 3, (True,) * 3),
    ("head_dim_20", torch.float32,
     lambda dt: [torch.zeros(1, 8, 3, 20, dtype=dt)] * 3, (False,) * 3),
    # a fused projection at head_dim 20: every view's strides are off
    ("fused_head_dim_20", torch.bfloat16,
     lambda dt: list(torch.zeros(1, 8, 3, 3, 20, dtype=dt).unbind(2)),
     (True,) * 3),
    # head_dim 40 in bf16 (80-byte heads) and 16 in f32 need no copy
    ("head_dim_40", torch.bfloat16,
     lambda dt: [torch.zeros(2, 9, 2, 40, dtype=dt)] * 3, (False,) * 3),
    ("head_dim_16", torch.float32,
     lambda dt: [torch.zeros(2, 9, 2, 16, dtype=dt)] * 3, (False,) * 3),
    # only k starts 2 bytes off a 16-byte boundary
    ("unaligned_base", torch.bfloat16,
     lambda dt: [torch.zeros(1, 8, 2, 64, dtype=dt),
                 _offset((1, 8, 2, 64), dt, 1),
                 torch.zeros(1, 8, 2, 64, dtype=dt)], (False, True, False)),
    # v broadcast over the batch: a stride of 0
    ("broadcast_batch", torch.float32,
     lambda dt: [torch.zeros(3, 8, 2, 64, dtype=dt)] * 2
     + [torch.zeros(1, 8, 2, 64, dtype=dt).expand(3, 8, 2, 64)],
     (False, False, True)),
    # a dimension of size 1 may have any stride
    ("size_1_dims", torch.bfloat16,
     lambda dt: [torch.zeros(1, 1, 1, 20, dtype=dt)] * 3, (False,) * 3),
]


@pytest.mark.parametrize("case,dtype,make,copies", _COPY_CASES,
                         ids=["%s-%s" % (c[0], str(c[1])[6:])
                              for c in _COPY_CASES])
def test_route_copies_what_the_kernels_cannot_read(case, dtype, make,
                                                   copies):
    q, k, v = make(dtype)
    assert kernel_route(q, k, v)[1] == copies


def test_padded_copy_layout():
    x = torch.arange(2 * 5 * 3 * 20, dtype=torch.float32).reshape(
        2, 5, 3, 20).to(torch.bfloat16)
    y = _padded_copy(x)
    assert y.shape == (2, 5, 3, 24) and y.is_contiguous()
    assert y.dtype == torch.bfloat16
    assert all(s * 2 % 16 == 0 for s in y.stride()[:3])
    assert torch.equal(y[..., :20], x)
    assert not y[..., 20:].any()


def test_padded_copy_arithmetic_matches_pallas_at_head_dim_20():
    """What the kernel computes on the wrapper's padded copy: the zero
    columns add nothing to Q K^T and give zero columns of O, so O's first
    20 columns and lse are those of head_dim 20, with its scale."""
    q, k, v = _qkv(5, 2, 40, 40, 3, 20)
    qp, kp, vp = (_padded_copy(torch.from_numpy(x)) for x in (q, k, v))
    o, lse = attention_reference(qp, kp, vp, causal=True,
                                 scale=1.0 / math.sqrt(20))
    assert not o[..., 20:].any()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = flash_attention(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(o[..., :20].numpy(), np.asarray(pallas),
                               **F32_TOL)
    _, jlse = _fwd_impl(_fold(q), _fold(k), _fold(v), True,
                        1.0 / math.sqrt(20), 128, 128, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :40],
                               **F32_TOL)


@pytest.mark.parametrize("case", ["float16", "head_dim_256", "strided_dim",
                                  "mixed_dtypes", "head_dim_0",
                                  "t_q_past_grid_f32", "t_q_past_grid_bf16"])
def test_kernel_refuses_what_it_cannot_run(case):
    q = torch.zeros(1, 8, 2, 32)
    k = v = None
    if case == "float16":
        q = q.half()
    elif case == "head_dim_256":
        q = torch.zeros(1, 8, 2, 256)
    elif case == "strided_dim":
        q = torch.zeros(1, 8, 64, 2).transpose(2, 3)
    elif case == "mixed_dtypes":
        k = v = q.to(torch.bfloat16)
    elif case == "head_dim_0":
        q = torch.zeros(1, 8, 2, 0)
    elif case == "t_q_past_grid_f32":
        # 65535 query tiles of 64 rows
        q = torch.zeros(1, 65535 * 64 + 1, 1, 16, device="meta")
    else:
        # 65535 query tiles of 128 rows; one row fewer fits
        q = torch.zeros(1, 65535 * 128 + 1, 1, 16, dtype=torch.bfloat16,
                        device="meta")
        ok = q[:, :-1]
        kernel_route(ok, ok, ok)
    with pytest.raises(MXNetError):
        kernel_route(q, k if k is not None else q, v if v is not None else q)


def test_mismatched_shapes_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(MXNetError):
        flash_attention_fwd(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
