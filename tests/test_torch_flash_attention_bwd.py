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
from mxnet_tpu_torch.op.kernels import build
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
    # one source per dtype, named as its kernel
    sources = {lib.name: lib.source.name for lib in fa.LIBRARIES}
    for name in fa.BWD_NAMES.values():
        assert sources[name] == name + ".cu" and \
            (build.CSRC / sources[name]).exists()
    assert not (build.CSRC / "flash_attention_bwd.cu").exists()


def test_autograd_function_under_no_grad_is_the_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 2, 9, 9, 2, 8))
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, True, None)
    torch.testing.assert_close(out, fa.attention_reference(q, k, v, True)[0])


def _bwd_inputs(dtype, device, b=1, t=8, h=3, d=64, fused=False):
    """q, k, v, o, do as the training path hands them to the backward:
    q, k, v the views of one fused projection, o and do contiguous."""
    if fused:
        qkv = torch.zeros(b, t, 3, h, d, dtype=dtype, device=device)
        q, k, v = qkv.unbind(2)
    else:
        q = k = v = torch.zeros(b, t, h, d, dtype=dtype, device=device)
    o = torch.zeros(b, t, h, d, dtype=dtype, device=device)
    return q, k, v, o, torch.zeros_like(o)


# (case, dtype, inputs -> (q, k, v, o, do), the copies the route makes)
_BWD_COPY_CASES = [
    # the serving head dim, fused or not, copies nothing in either dtype
    ("fused_head_dim_64", torch.bfloat16,
     lambda dt, dev: _bwd_inputs(dt, dev, fused=True), (False,) * 5),
    ("fused_head_dim_64", torch.float32,
     lambda dt, dev: _bwd_inputs(dt, dev, fused=True), (False,) * 5),
    ("head_dim_40", torch.bfloat16,
     lambda dt, dev: _bwd_inputs(dt, dev, d=40), (False,) * 5),
    # head_dim 20: bfloat16 strides of 40 bytes; TMA reads k, v, do, and
    # the preprocess reads q and o by element
    ("fused_head_dim_20", torch.bfloat16,
     lambda dt, dev: _bwd_inputs(dt, dev, d=20, fused=True),
     (False, True, True, False, True)),
    ("head_dim_20", torch.bfloat16,
     lambda dt, dev: _bwd_inputs(dt, dev, d=20),
     (False, True, True, False, True)),
    # float32 rows of 80 bytes are 16-byte aligned
    ("fused_head_dim_20", torch.float32,
     lambda dt, dev: _bwd_inputs(dt, dev, d=20, fused=True), (False,) * 5),
    # float32 head_dim 5: 20-byte rows; cp.async reads q, k, v, do
    ("head_dim_5", torch.float32,
     lambda dt, dev: _bwd_inputs(dt, dev, d=5),
     (True, True, True, False, True)),
    # an output gradient whose last dimension is not contiguous
    ("strided_do", torch.float32,
     lambda dt, dev: _bwd_inputs(dt, dev)[:4]
     + (torch.zeros(1, 8, 64, 3, dtype=dt, device=dev).transpose(2, 3),),
     (False, False, False, False, True)),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case,dtype,make,copies", _BWD_COPY_CASES,
                         ids=["%s-%s" % (c[0], str(c[1])[6:])
                              for c in _BWD_COPY_CASES])
def test_bwd_route_picks_the_kernel_and_its_copies(case, dtype, make, copies,
                                                   device):
    name, route_copies = fa.bwd_route(*make(dtype, device))
    assert name == fa.BWD_NAMES[dtype] == (
        "flash_attention_bwd_bf16" if dtype == torch.bfloat16
        else "flash_attention_bwd_f32")
    assert route_copies == copies


@pytest.mark.parametrize("case", ["float16", "mixed_dtypes", "head_dim_129",
                                  "head_dim_0", "t_past_grid"])
def test_bwd_route_refuses_what_no_kernel_runs(case):
    q, k, v, o, do = _bwd_inputs(torch.float32, "meta")
    if case == "float16":
        q, k, v, o, do = (x.half() for x in (q, k, v, o, do))
    elif case == "mixed_dtypes":
        do = do.to(torch.bfloat16)
    elif case in ("head_dim_129", "head_dim_0"):
        d = 129 if case == "head_dim_129" else 0
        q, k, v, o, do = _bwd_inputs(torch.bfloat16, "meta", d=d)
    else:
        # 65535 tiles of 64 rows; one row fewer fits
        q, k, v, o, do = _bwd_inputs(torch.bfloat16, "meta", t=65535 * 64 + 1)
        fa.bwd_route(*(x[:, :-1] for x in (q, k, v, o, do)))
    with pytest.raises(MXNetError):
        fa.bwd_route(q, k, v, o, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_copy_arithmetic_of_the_backward(dtype):
    """What the kernels compute on the wrapper's zero-padded copies (and
    what the bfloat16 kernels compute on q_s, zero-padded to their
    width): with head_dim 20's scale, the padded columns add nothing, so
    the first 20 columns are the unpadded gradients and the rest 0."""
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(5, 2, 40, 40, 3, 20))
    scale = 1.0 / math.sqrt(20)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.attention_bwd_reference(q, k, v, o, lse, g, causal=True)
    padded = [fa._padded_copy(x) for x in (q, k, v, o, g)]
    got = fa.attention_bwd_reference(*padded[:4], lse, padded[4],
                                     causal=True, scale=scale)
    for x, w in zip(got, want):
        assert x.shape[-1] == 24 and x.dtype == dtype
        assert torch.equal(x[..., :20], w)
        assert not x[..., 20:].any()


def test_library_digest_covers_included_headers(tmp_path):
    """A source's library is named by a digest of the source and of the
    headers it includes by quotes, so an edited header rebuilds it."""
    (tmp_path / "inner.cuh").write_text("// inner v1\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "kern.cu"
    src.write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n')
    first = build.source_digest(src)
    assert build.source_digest(src) == first
    (tmp_path / "inner.cuh").write_text("// inner v2\n")
    second = build.source_digest(src)
    assert second != first
    src.write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n// x\n')
    assert build.source_digest(src) not in (first, second)
    # the bfloat16 kernels share csrc/hopper.cuh
    for name in ("flash_attention_fwd_bf16", "flash_attention_bwd_bf16"):
        assert '#include "hopper.cuh"' in (build.CSRC / (name + ".cu")) \
            .read_text()
