"""The port's ``mt.rtc`` against ``mxnet_tpu``'s ``mx.rtc``.

On the CPU the port runs its ``language="torch"`` kernels, the plain
versions of its ``language="cuda"`` ones; they are held against the JAX
package's ``language="jax"`` kernels and its Pallas kernel run by the
Pallas interpreter (as ``tests/test_rtc.py`` runs it).  The CUDA path is
checked here as far as it runs without a card: the decorated source,
and that it refuses what it cannot run.  ``chip_smoke.py`` compiles and
runs it on the card."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc

TOL = dict(rtol=1e-6, atol=1e-6)

_X = np.arange(12, dtype="f").reshape(3, 4) - 4.5
# (name, [(input name, value)], [(output name, shape)], jax body,
#  torch body)
CASES = [
    ("axpy", [("x", _X), ("alpha_", np.array([2.0], "f"))], [("y", (3, 4))],
     "y = alpha_ * x + 1", "y = alpha_ * x + 1"),
    ("sincos", [("x", np.arange(6, dtype="f"))], [("s", (6,)), ("c", (6,))],
     "s = jnp.sin(x)\nc = jnp.cos(x)", "s = torch.sin(x)\nc = torch.cos(x)"),
    ("gelu_tanh", [("x", _X)], [("y", (3, 4))],
     "y = jax.nn.gelu(x)",
     "y = 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)"
     " * (x + 0.044715 * x ** 3)))"),
]


def _run(pkg, name, inputs, outputs, body, language, ctx=None):
    ins = [(n, pkg.nd.array(v, ctx=ctx) if ctx else pkg.nd.array(v))
           for n, v in inputs]
    outs = [(n, pkg.nd.zeros(s, ctx=ctx) if ctx else pkg.nd.zeros(s))
            for n, s in outputs]
    k = pkg.rtc.Rtc(name, ins, outs, body, language=language)
    res = k.push([a for _, a in ins], [a for _, a in outs])
    return [a.asnumpy() for a in res]


@pytest.mark.parametrize("name,inputs,outputs,jbody,tbody", CASES,
                         ids=[c[0] for c in CASES])
def test_torch_language_matches_jax_language(name, inputs, outputs, jbody,
                                             tbody):
    before = mt.rtc.Rtc.launches
    jout = _run(mx, name, inputs, outputs, jbody, "jax")
    tout = _run(mt, name, inputs, outputs, tbody, "torch", ctx=mt.cpu())
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, **TOL)
    assert mt.rtc.Rtc.launches == before   # the torch language never counts


def test_torch_language_matches_interpreted_pallas():
    """``tests/test_rtc.py``'s Pallas kernel, run by the interpreter."""
    x = np.arange(64, dtype="f").reshape(8, 8)
    jout = _run(mx, "scale2", [("x", x)], [("y", (8, 8))],
                "y_ref[...] = x_ref[...] * 2.0", "pallas")
    tout = _run(mt, "scale2", [("x", x)], [("y", (8, 8))],
                "y = x * 2.0", "torch", ctx=mt.cpu())
    np.testing.assert_array_equal(tout[0], jout[0])


def test_torch_language_outputs():
    """Results are cast to the output's dtype and written in place (into
    an NDArray view or a tensor); every output must be assigned, in its
    shape."""
    base = torch.zeros(4, 6)
    with mt.cpu():
        x = mt.nd.array(np.arange(8, dtype="f").reshape(2, 4) + 0.75)
        as_int = mt.nd.zeros((2, 4), dtype="int32")
        k = mt.rtc.Rtc("k", [("x", x)], [("a", x), ("b", x)],
                       "a = x * 2\nb = -x", language="torch")
        k([x], [as_int, torch.zeros(2, 4)])
        np.testing.assert_array_equal(as_int.asnumpy(),
                                      (x.asnumpy() * 2).astype(np.int32))
        k.push([x], [mt.nd.NDArray(base[1:3, 1:5]), torch.zeros(4, 2).t()])
        np.testing.assert_array_equal(base[1:3, 1:5].numpy(),
                                      x.asnumpy() * 2)
        assert float(base[1:3, 0].abs().sum()) == 0.0
        with pytest.raises(mt.MXNetError, match="did not assign"):
            mt.rtc.Rtc("bad", [("x", x)], [("y", x)], "z = x * 2",
                       language="torch").push([x], [x.copy()])
        with pytest.raises(mt.MXNetError, match="shape"):
            mt.rtc.Rtc("sum", [("x", x)], [("y", x)], "y = x.sum()",
                       language="torch").push([x], [x.copy()])
        with pytest.raises(mt.MXNetError, match="expected 1 inputs"):
            k.push([], [x, x])


def test_decorated_cuda_source():
    """The reference's decoration: one pointer per input (const) then per
    output, typed from the dtype, and size/ndim/shape constants."""
    src = rtc.decorate(
        "axpy", [("x", (3, 4), torch.float32), ("alpha_", (1,), torch.int64),
                 ("h", (2, 2, 2), torch.float16)],
        [("y", (3, 4), torch.bfloat16), ("m", (5,), torch.uint8)],
        "    if (threadIdx.x == 0) y[0] = x[0];")
    assert src.startswith("#include <cuda_bf16.h>\n#include <cuda_fp16.h>\n")
    assert ('extern "C" __global__ void axpy(const float* x, '
            'const long long* alpha_, const __half* h, __nv_bfloat16* y, '
            'unsigned char* m)\n{\n') in src
    for line in ("constexpr long long x_size = 12;",
                 "constexpr int x_ndim = 2;",
                 "constexpr long long x_shape[2] = {3, 4};",
                 "constexpr long long h_shape[3] = {2, 2, 2};",
                 "constexpr long long m_size = 5;",
                 "constexpr long long alpha__shape[1] = {1};"):
        assert "    [[maybe_unused]] " + line + "\n" in src
    assert src.endswith("    if (threadIdx.x == 0) y[0] = x[0];\n}\n")
    f32 = rtc.decorate("k", [("a", (2,), torch.int32)],
                       [("b", (), torch.float32)], "")
    assert "#include" not in f32 and "b_shape" not in f32
    assert "void k(const int* a, float* b)" in f32
    with pytest.raises(mt.MXNetError, match="dtype"):
        rtc.decorate("k", [("a", (2,), torch.complex64)], [], "")
    with pytest.raises(mt.MXNetError, match="C identifier"):
        rtc.decorate("k", [("a-b", (2,), torch.float32)], [], "")


def test_cuda_language_refuses_what_it_cannot_run(monkeypatch, tmp_path):
    """No fallback: Pallas names the CUDA language, CPU arrays raise, a
    machine without NVRTC raises, and bad launch dims raise."""
    with mt.cpu():
        x = mt.nd.ones((4,))
    with pytest.raises(mt.MXNetError, match="language='cuda'"):
        mt.rtc.Rtc("k", [("x", x)], [("y", x)], "y_ref[...] = x_ref[...]",
                   language="pallas")
    with pytest.raises(mt.MXNetError, match="one CUDA device"):
        mt.rtc.Rtc("k", [("x", x)], [("y", x)], "y[0] = x[0];")
    with pytest.raises(mt.MXNetError, match="unknown rtc language"):
        mt.rtc.Rtc("k", [("x", x)], [("y", x)], "", language="triton")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("sys.path", [str(tmp_path)])
    monkeypatch.setattr(rtc, "_LIBS", {})
    with pytest.raises(mt.MXNetError, match="NVRTC"):
        rtc.nvrtc_version()
    with pytest.raises(mt.MXNetError, match="grid_dims"):
        rtc._dims((2, 1), "grid_dims")
    with pytest.raises(mt.MXNetError, match="block_dims"):
        rtc._dims((0, 1, 1), "block_dims")
