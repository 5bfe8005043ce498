"""Every op of the port's serving slice against the ``mxnet_tpu`` op of the
same name: the same params and the same numpy inputs through both op
bodies, and through both packages' shape inference."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.op import registry as jax_reg
from mxnet_tpu_torch.op import registry as torch_reg

# both sides compute in float32; sums and transcendental functions round
# differently by a few ulps
TOL = dict(rtol=1e-5, atol=1e-6)


def _normal(*shape):
    return lambda rng: rng.normal(0, 1, shape).astype(np.float32)


def _positive(*shape):
    return lambda rng: rng.uniform(0.5, 2.0, shape).astype(np.float32)


def _ints(*shape):
    return lambda rng: rng.randint(-9, 10, shape).astype(np.int32)


def _ids(*shape, dtype=np.float32):
    # token ids with out-of-range values at both ends: both packages clamp
    def make(rng):
        ids = rng.randint(0, 10, shape).astype(dtype)
        ids.flat[0] = 25
        ids.flat[1] = -3
        return ids
    return make


CASES = [
    # (id, op name, params, input makers)
    ("reshape_copy_infer", "Reshape", {"shape": (0, -1)}, [_normal(2, 3, 4)]),
    ("reshape_infer_only", "Reshape", {"shape": (-1,)}, [_normal(2, 3, 4)]),
    ("reshape_copy_rest", "Reshape", {"shape": (-2,)}, [_normal(2, 3, 4)]),
    ("reshape_merge_two", "Reshape", {"shape": (0, -3)}, [_normal(2, 3, 4)]),
    ("reshape_split", "Reshape", {"shape": (-4, 1, 2, -2)}, [_normal(2, 3, 4)]),
    ("reshape_split_infer", "Reshape", {"shape": (-4, -1, 2, 0, 0)},
     [_normal(2, 3, 4)]),
    ("reshape_json_string", "Reshape", {"shape": "(1, 8, 3)"},
     [_normal(8, 3)]),
    ("slice_axis", "slice_axis", {"axis": 2, "begin": 1, "end": 2},
     [_normal(2, 4, 3, 2, 5)]),
    ("slice_axis_negative", "slice_axis",
     {"axis": -1, "begin": -3, "end": "None"}, [_normal(2, 6)]),
    ("embedding_float_ids_clip", "Embedding",
     {"input_dim": 10, "output_dim": 6}, [_ids(3, 4), _normal(10, 6)]),
    ("embedding_int_ids_clip", "Embedding",
     {"input_dim": 10, "output_dim": 6},
     [_ids(3, 4, dtype=np.int32), _normal(10, 6)]),
    ("arange", "_arange", {"start": 0, "stop": 8}, []),
    ("arange_step_repeat", "_arange",
     {"start": 2, "stop": 11, "step": 3, "repeat": 2}, []),
    ("arange_stop_none", "_arange", {"start": 5}, []),
    ("plus", "_plus", {}, [_normal(4, 5), _normal(4, 5)]),
    ("plus_alias_Plus", "_Plus", {}, [_normal(4, 5), _normal(4, 5)]),
    ("plus_alias_elemwise_add", "elemwise_add", {},
     [_normal(4, 5), _normal(4, 5)]),
    ("broadcast_add", "broadcast_add", {},
     [_normal(2, 8, 3), _normal(1, 8, 3)]),
    ("minus", "_minus", {}, [_normal(4, 5), _normal(4, 5)]),
    ("minus_alias_elemwise_sub", "elemwise_sub", {},
     [_normal(4, 5), _normal(4, 5)]),
    ("mul_alias_Mul", "_Mul", {}, [_normal(4, 5), _normal(4, 5)]),
    ("div_alias_Div", "_Div", {}, [_normal(4, 5), _positive(4, 5)]),
    ("power", "_power", {}, [_positive(4, 5), _normal(4, 5)]),
    ("broadcast_sub", "broadcast_sub", {}, [_normal(2, 3), _normal(2, 1)]),
    ("broadcast_mul", "broadcast_mul", {}, [_normal(2, 3), _normal(1, 3)]),
    ("broadcast_div", "broadcast_div", {}, [_normal(2, 3), _positive(2, 1)]),
    ("broadcast_power", "broadcast_power", {},
     [_positive(2, 3), _normal(1, 3)]),
    ("plus_scalar", "_plus_scalar", {"scalar": 1.5}, [_normal(3, 4)]),
    # the scalar takes the array's dtype in both packages: 2.5 -> 2
    ("plus_scalar_int", "_plus_scalar", {"scalar": 2.5}, [_ints(3, 4)]),
    ("minus_scalar", "_minus_scalar", {"scalar": "0.25"}, [_normal(3, 4)]),
    ("mul_scalar", "_mul_scalar", {"scalar": -1.0}, [_normal(3, 4)]),
    ("div_scalar", "_div_scalar", {"scalar": 3.0}, [_normal(3, 4)]),
    # true division of ints gives float32 in both packages
    ("div_scalar_int", "_div_scalar", {"scalar": 4.0}, [_ints(3, 4)]),
    ("power_scalar", "_power_scalar", {"scalar": 2.0}, [_normal(3, 4)]),
    ("rminus_scalar", "_rminus_scalar", {"scalar": 1.0}, [_normal(3, 4)]),
    ("rdiv_scalar", "_rdiv_scalar", {"scalar": 2.0}, [_positive(3, 4)]),
    ("rpower_scalar", "_rpower_scalar", {"scalar": 2.0}, [_normal(3, 4)]),
    ("fully_connected", "FullyConnected", {"num_hidden": 7},
     [_normal(5, 6), _normal(7, 6), _normal(7)]),
    ("fully_connected_flattens", "FullyConnected",
     {"num_hidden": 7, "flatten": False},
     [_normal(5, 2, 3), _normal(7, 6), _normal(7)]),
    ("fully_connected_no_bias", "FullyConnected",
     {"num_hidden": 7, "no_bias": True}, [_normal(5, 6), _normal(7, 6)]),
    ("activation_relu", "Activation", {"act_type": "relu"}, [_normal(4, 9)]),
    ("activation_sigmoid", "Activation", {"act_type": "sigmoid"},
     [_normal(4, 9)]),
    ("activation_tanh", "Activation", {"act_type": "tanh"}, [_normal(4, 9)]),
    ("activation_softrelu", "Activation", {"act_type": "softrelu"},
     [_normal(4, 9)]),
    # jax.nn.gelu's default, the tanh approximation (GPT-2's gelu_new)
    ("activation_gelu_tanh", "Activation", {"act_type": "gelu"},
     [lambda rng: (4 * rng.normal(0, 1, (4, 9))).astype(np.float32)]),
    ("layer_norm", "LayerNorm", {},
     [lambda rng: (3 + 2 * rng.normal(0, 1, (6, 8))).astype(np.float32),
      _normal(8), _normal(8)]),
    ("layer_norm_axis1", "LayerNorm", {"axis": 1, "eps": 1e-3},
     [_normal(2, 5, 3), _normal(5), _normal(5)]),
    ("dropout_eval_identity", "Dropout", {"p": 0.5}, [_normal(4, 9)]),
    ("softmax_output", "SoftmaxOutput", {},
     [_normal(6, 11), lambda rng: np.zeros((6,), np.float32)]),
    ("softmax_output_flattens", "SoftmaxOutput", {},
     [_normal(3, 4, 5), lambda rng: np.zeros((3,), np.float32)]),
    ("softmax_output_multi", "SoftmaxOutput", {"multi_output": True},
     [_normal(3, 4, 5), lambda rng: np.zeros((3, 5), np.float32)]),
    ("softmax_output_preserve", "SoftmaxOutput", {"preserve_shape": True},
     [_normal(3, 4, 5), lambda rng: np.zeros((3, 4), np.float32)]),
    ("attention_flash_causal", "_contrib_DotProductAttention",
     {"causal": True, "block_q": 16, "block_k": 16},
     [_normal(2, 24, 2, 8), _normal(2, 24, 2, 8), _normal(2, 24, 2, 8)]),
    ("attention_plain_scaled", "_contrib_DotProductAttention",
     {"flash": False, "scale": 0.5},
     [_normal(2, 9, 2, 8), _normal(2, 13, 2, 8), _normal(2, 13, 2, 8)]),
]


def _signed(*shape):
    # both signs, away from 0: divisors of mod and friends
    return lambda rng: (rng.choice([-1.0, 1.0], shape)
                        * rng.uniform(0.5, 3.0, shape)).astype(np.float32)


def _between(lo, hi, *shape):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def _fixed(values, dtype=np.float32):
    return lambda rng: np.array(values, dtype)


# halves round to even; negatives truncate toward 0; Γ < 0 on (-1, 0),
# (-3, -2); cube roots of negatives are negative
_EDGES = _fixed([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -3.7, -0.2, 2.6, 7.0])
_GAMMA_ARGS = _fixed([-2.5, -1.5, -0.5, 0.5, 1.5, 3.2, 4.0])
_DOMAINS = {
    "abs": _normal(3, 4), "sign": _fixed([-2.0, 0.0, 3.0]),
    "rint": _EDGES, "round": _EDGES, "ceil": _EDGES, "floor": _EDGES,
    "trunc": _EDGES, "fix": _EDGES, "square": _normal(3, 4),
    "sqrt": _positive(3, 4), "rsqrt": _positive(3, 4), "cbrt": _EDGES,
    "rcbrt": _signed(3, 4), "exp": _normal(3, 4), "log": _positive(3, 4),
    "log10": _positive(3, 4), "log2": _positive(3, 4),
    "log1p": _positive(3, 4), "expm1": _normal(3, 4), "sin": _normal(3, 4),
    "cos": _normal(3, 4), "tan": _between(-1.2, 1.2, 3, 4),
    "arcsin": _between(-0.99, 0.99, 3, 4),
    "arccos": _between(-0.99, 0.99, 3, 4), "arctan": _normal(3, 4),
    "sinh": _normal(3, 4), "cosh": _normal(3, 4), "tanh": _normal(3, 4),
    "arcsinh": _normal(3, 4), "arccosh": _between(1.01, 4.0, 3, 4),
    "arctanh": _between(-0.99, 0.99, 3, 4), "degrees": _normal(3, 4),
    "radians": _normal(3, 4), "gamma": _GAMMA_ARGS, "gammaln": _GAMMA_ARGS,
    "negative": _normal(3, 4), "reciprocal": _signed(3, 4),
    "sigmoid": _normal(3, 4),
    "softrelu": _fixed([-30.0, -2.0, 0.0, 1.5, 19.0, 25.0, 40.0]),
    "erf": _normal(3, 4), "relu": _normal(3, 4), "identity": _normal(3, 4),
    "_copy": _normal(3, 4),
}
_IDS = _fixed([[0, 2, 1, 7], [-1, 3, 1.9, 0]])
_NAN = _fixed([[1.5, np.nan, 2.0], [np.nan, -0.5, 3.0]])

CASES += [("unary_" + n, n, {}, [make]) for n, make in _DOMAINS.items()]
for _n, _lhs, _rhs in (("mod", _signed(4, 5), _signed(4, 5)),
                       ("maximum", _normal(4, 5), _normal(4, 5)),
                       ("minimum", _normal(4, 5), _normal(4, 5)),
                       ("hypot", _normal(4, 5), _normal(4, 5)),
                       ("equal", _ints(4, 5), _ints(4, 5)),
                       ("not_equal", _normal(4, 5), _normal(4, 5)),
                       ("greater", _normal(4, 5), _normal(4, 5)),
                       ("greater_equal", _ints(4, 5), _ints(4, 5)),
                       ("lesser", _normal(4, 5), _normal(4, 5)),
                       ("lesser_equal", _ints(4, 5), _ints(4, 5))):
    CASES += [
        (_n, "_" + _n, {}, [_lhs, _rhs]),
        ("broadcast_" + _n, "broadcast_" + _n, {},
         [_lhs, lambda rng, _rhs=_rhs: _rhs(rng)[:1]]),
        (_n + "_scalar", "_%s_scalar" % _n, {"scalar": -1.5}, [_lhs]),
    ]
CASES += [
    # the sign of a modulo follows the divisor, as in Python
    ("mod_ints", "_mod", {}, [_ints(4, 5), _fixed([[3], [-3], [4], [-7]],
                                                  np.int32)]),
    ("mod_scalar_positive", "_mod_scalar", {"scalar": 2.5}, [_signed(3, 4)]),
    ("rmod_scalar", "_rmod_scalar", {"scalar": 3.0}, [_signed(3, 4)]),
    ("rpower_scalar_half", "_rpower_scalar", {"scalar": 0.5},
     [_normal(3, 4)]),
    ("clip", "clip", {"a_min": -0.5, "a_max": 0.7}, [_normal(3, 4)]),
    ("smooth_l1", "smooth_l1", {"scalar": 2.0}, [_normal(3, 4)]),
    ("add_n", "add_n", {"num_args": 3},
     [_normal(3, 4), _normal(3, 4), _normal(3, 4)]),
    ("add_n_alias_ElementWiseSum", "ElementWiseSum", {"num_args": 2},
     [_normal(3, 4), _normal(3, 4)]),
    ("flatten", "Flatten", {}, [_normal(2, 3, 4)]),
    ("transpose_reverse", "transpose", {}, [_normal(2, 3, 4)]),
    ("transpose_axes", "transpose", {"axes": "(1, 0, 2)"},
     [_normal(2, 3, 4)]),
    ("expand_dims", "expand_dims", {"axis": 1}, [_normal(2, 3)]),
    ("concat", "Concat", {"num_args": 2, "dim": 1},
     [_normal(2, 3), _normal(2, 5)]),
    ("concat_alias_dim0", "concat", {"num_args": 2, "dim": 0},
     [_normal(2, 3), _normal(1, 3)]),
    ("cast_truncates", "Cast", {"dtype": "int32"}, [_EDGES]),
    ("cast_alias", "cast", {"dtype": "float16"}, [_normal(3, 4)]),
    ("broadcast_to", "broadcast_to", {"shape": (0, 3, 4)},
     [_normal(2, 1, 4)]),
    ("dot", "dot", {}, [_normal(3, 5), _normal(5, 4)]),
    ("dot_transpose_b", "dot", {"transpose_b": True},
     [_normal(3, 5), _normal(4, 5)]),
    ("dot_vectors", "dot", {}, [_normal(6), _normal(6)]),
    ("batch_dot_transpose_a", "batch_dot", {"transpose_a": True},
     [_normal(2, 5, 3), _normal(2, 5, 4)]),
    ("sum_all", "sum", {}, [_normal(3, 4, 2)]),
    ("sum_axis_tuple_keepdims", "sum", {"axis": (0, 2), "keepdims": True},
     [_normal(3, 4, 2)]),
    ("sum_int_keeps_dtype", "sum", {"axis": 1}, [_ints(3, 4)]),
    ("sum_axis_alias", "sum_axis", {"axis": -1}, [_normal(3, 4)]),
    ("mean", "mean", {"axis": 1}, [_normal(3, 4)]),
    ("mean_int_is_float", "mean", {}, [_ints(3, 4)]),
    ("max", "max", {"axis": 0}, [_normal(3, 4)]),
    ("max_axis_alias", "max_axis", {"axis": 1, "keepdims": True},
     [_normal(3, 4)]),
    ("min_all", "min", {}, [_normal(3, 4)]),
    ("min_axis_alias", "min_axis", {"axis": "(0, 1)"}, [_normal(3, 4, 2)]),
    ("prod_axes", "prod", {"axis": (0, 1)}, [_between(0.5, 1.5, 3, 4, 2)]),
    ("prod_all", "prod", {}, [_between(0.5, 1.5, 3, 4)]),
    ("nansum", "nansum", {"axis": 1}, [_NAN]),
    ("nanprod", "nanprod", {}, [_NAN]),
    ("norm", "norm", {}, [_normal(3, 4)]),
    ("argmax_flat", "argmax", {}, [_normal(3, 4)]),
    ("argmax_axis_keepdims", "argmax", {"axis": 1, "keepdims": True},
     [_normal(3, 4)]),
    ("argmin_axis", "argmin", {"axis": 0}, [_normal(3, 4)]),
    # out-of-range ids give rows of zeros; 1.9 truncates to 1
    ("one_hot", "one_hot", {"depth": 5, "on_value": 2.0,
                            "off_value": -1.0}, [_IDS]),
    ("one_hot_int_dtype", "one_hot", {"depth": 4, "dtype": "int32"},
     [_IDS]),
    ("zeros_like", "zeros_like", {}, [_ints(3, 4)]),
    ("ones_like", "ones_like", {}, [_normal(3, 4)]),
    # a dimension of 0 (unknown) is made 1
    ("zeros_unknown_dim", "_zeros", {"shape": (2, 0, 3)}, []),
    ("ones_alias_int", "ones", {"shape": (2, 3), "dtype": "int32"}, []),
    ("full", "_full", {"shape": "(3, 2)", "value": 1.25}, []),
]


@pytest.mark.parametrize("name,params,makers",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_op_matches_mxnet_tpu(name, params, makers):
    rng = np.random.RandomState(0)
    arrays = [make(rng) for make in makers]
    jop, top = jax_reg.get(name), torch_reg.get(name)
    jp, tp = jop.parse_params(dict(params)), top.parse_params(dict(params))
    (jout,), _ = jop.apply(jp, jax_reg.OpContext(platform="cpu"),
                           *(jnp.asarray(a) for a in arrays))
    (tout,), _ = top.apply(tp, torch_reg.OpContext(),
                           *(torch.from_numpy(a) for a in arrays))
    jout = np.asarray(jout)
    assert tuple(tout.shape) == jout.shape
    assert str(tout.dtype).replace("torch.", "") == jout.dtype.name
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)

    shapes = [a.shape for a in arrays]
    j_in, j_out, _ = jop.infer_shape_generic(jp, shapes)
    t_in, t_out, _ = top.infer_shape_generic(tp, shapes)
    assert [tuple(s) for s in t_in] == [tuple(s) for s in j_in]
    assert [tuple(s) for s in t_out] == [tuple(s) for s in j_out] \
        == [jout.shape]


def _arithmetic(sym):
    a, b, c = sym.Variable("a"), sym.Variable("b"), sym.Variable("c")
    return (-((a + b) * 2.0 - c / b) ** 2.0 + 1.0 - a) * (3 * c) \
        + 2.0 / b - a ** b + (1.5 + a) - b * c


def test_symbol_operators_match_mxnet_tpu():
    """The Symbol's arithmetic operators build the same graph (the same
    JSON) in both packages, and it evaluates to the same values."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.serving import CompiledForward

    with mx.name.NameManager():
        jsym = _arithmetic(mx.sym)
    with mt.name.NameManager():
        tsym = _arithmetic(mt.sym)
    assert tsym.tojson() == jsym.tojson()
    rng = np.random.RandomState(0)
    vals = {"a": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
            "b": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
            "c": rng.normal(0, 1, (3, 4)).astype(np.float32)}
    (jout,) = jsym.eval(mx.cpu(), **{k: mx.nd.array(v)
                                     for k, v in vals.items()})
    (tout,) = CompiledForward(tsym, list(vals)).run(
        {}, {}, {k: torch.from_numpy(v) for k, v in vals.items()})
    np.testing.assert_allclose(tout.numpy(), jout.asnumpy(), **TOL)
    with pytest.raises(mt.MXNetError):
        tsym.__rsub__(tsym)
