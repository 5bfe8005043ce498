"""The port's ``RNN`` op, ``SliceChannel``/``split`` and ``where`` against
the ``mxnet_tpu`` ops of the same names: the same params and numpy inputs
through both op bodies, their outputs, and every input's gradient under
one random cotangent per output (``jax.vjp`` against torch autograd)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.op import registry as jax_reg
from mxnet_tpu.op.rnn_op import rnn_param_size as jax_param_size
from mxnet_tpu_torch.op import registry as torch_reg
from mxnet_tpu_torch.op.rnn_op import rnn_param_size

# float32 on both sides; the recurrences sum a few products a step in
# another order, so values and gradients agree to a few ulps of their
# scale: every element within REL of the largest magnitude of its array
# (a gradient entry near zero after cancellation keeps only that)
REL = 1e-5


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, "max error %.3g of the array's scale, over %g" % (
        err, rel)


def _both(name, params, arrays, is_train=False):
    """Outputs and input gradients of ``name`` in each package, as numpy:
    ``(jax_outs, jax_grads, torch_outs, torch_grads)``."""
    jop, top = jax_reg.get(name), torch_reg.get(name)
    jp, tp = jop.parse_params(dict(params)), top.parse_params(dict(params))
    rng = np.random.RandomState(1)

    def jfn(*xs):
        return jop.apply(jp, jax_reg.OpContext(is_train=is_train,
                                               platform="cpu"), *xs)[0]

    # one jitted program for the forward and its vjp: a fraction of the
    # op-by-op cost of a scan's vjp
    @jax.jit
    def fwd_bwd(xs, cots):
        outs, vjp = jax.vjp(jfn, *xs)
        return outs, vjp(cots)

    xs = tuple(jnp.asarray(a) for a in arrays)
    out_shapes = jax.eval_shape(jfn, *xs)
    cots = [rng.normal(0, 1, o.shape).astype(np.float32) for o in out_shapes]
    jouts, jgrads = fwd_bwd(xs, tuple(jnp.asarray(c) for c in cots))

    leaves = [torch.from_numpy(a.copy()).requires_grad_(a.dtype.kind == "f")
              for a in arrays]
    touts, _ = top.apply(tp, torch_reg.OpContext(is_train=is_train,
                                                 record=True), *leaves)
    diff = [x for x in leaves if x.requires_grad]
    tgrads = torch.autograd.grad(touts, diff,
                                 [torch.from_numpy(c) for c in cots],
                                 allow_unused=True)
    tgrads = iter(tgrads)
    tg = [next(tgrads) if x.requires_grad else None for x in leaves]
    return ([np.asarray(o) for o in jouts], [np.asarray(g) for g in jgrads],
            [o.detach().numpy() for o in touts],
            [None if g is None else g.numpy() for g in tg])


def _rnn_inputs(mode, T, N, I, H, L, bidir, rng):
    D = 2 if bidir else 1
    psize = rnn_param_size(mode, I, H, L, bidir)
    arrays = [rng.normal(0, 1, (T, N, I)).astype(np.float32),
              rng.uniform(-0.4, 0.4, (psize,)).astype(np.float32),
              rng.normal(0, 0.5, (L * D, N, H)).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rng.normal(0, 0.5, (L * D, N, H)).astype(np.float32))
    return arrays


MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
# every mode, layer count and direction with the final states as outputs,
# and each mode once with the sequence output alone
RNN_CASES = [(mode, layers, bidir, True) for mode in MODES
             for layers in (1, 2) for bidir in (False, True)] + \
    [(mode, 2, True, False) for mode in MODES]


@pytest.mark.parametrize(
    "mode,layers,bidir,state_outputs", RNN_CASES,
    ids=["%s-L%d-%s-%s" % (m, n, "bi" if b else "uni",
                           "states" if so else "out")
         for m, n, b, so in RNN_CASES])
def test_rnn_op_matches_mxnet_tpu(mode, layers, bidir, state_outputs):
    rng = np.random.RandomState(0)
    T, N, I, H = 5, 3, 6, 8
    arrays = _rnn_inputs(mode, T, N, I, H, layers, bidir, rng)
    params = dict(state_size=H, num_layers=layers, mode=mode,
                  bidirectional=bidir, state_outputs=state_outputs)
    jo, jg, to, tg = _both("RNN", params, arrays)
    assert len(to) == len(jo) == (1 if not state_outputs
                                  else 3 if mode == "lstm" else 2)
    for t, j in zip(to + tg, jo + jg):
        assert_close(t, j)
    assert rnn_param_size(mode, I, H, layers, bidir) == \
        jax_param_size(mode, I, H, layers, bidir)


@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
def test_lstm_state_clip_matches_mxnet_tpu(bidir):
    rng = np.random.RandomState(3)
    arrays = _rnn_inputs("lstm", 6, 2, 4, 5, 2, bidir, rng)
    arrays[1] *= 4.0        # large gates push the cell state past the clip
    params = dict(state_size=5, num_layers=2, mode="lstm",
                  bidirectional=bidir, state_outputs=True,
                  lstm_state_clip_min=-0.3, lstm_state_clip_max=0.25)
    jo, jg, to, tg = _both("RNN", params, arrays)
    assert to[2].max() <= 0.25 and to[2].min() >= -0.3
    assert np.isclose(np.abs(to[2]), 0.25).any() or \
        np.isclose(to[2], -0.3).any()
    for t, j in zip(to + tg, jo + jg):
        assert_close(t, j)


def test_rnn_shape_inference_matches_mxnet_tpu():
    for mode, layers, bidir, _ in RNN_CASES:
        for so in (False, True):
            p = dict(state_size=7, num_layers=layers, mode=mode,
                     bidirectional=bidir, state_outputs=so)
            jop, top = jax_reg.get("RNN"), torch_reg.get("RNN")
            jp, tp = jop.parse_params(dict(p)), top.parse_params(dict(p))
            shapes = [(9, 4, 5), None, None] + \
                ([None] if mode == "lstm" else [])
            j_in, j_out, _ = jop.infer_shape_generic(jp, shapes)
            t_in, t_out, _ = top.infer_shape_generic(tp, shapes)
            assert [tuple(s) for s in t_in] == [tuple(s) for s in j_in]
            assert [tuple(s) for s in t_out] == [tuple(s) for s in j_out]
            assert top.list_inputs(tp) == jop.list_inputs(jp)
            assert top.list_outputs(tp) == jop.list_outputs(jp)


def _dropout_probe(p, seed, is_train=True):
    """A 2-layer ``rnn_relu`` whose second layer passes its input through
    (identity i2h, zero h2h, zero biases), so its output is the first
    layer's output after the op's inter-layer dropout.  Returns
    ``(first layer's output, op output)``."""
    T, N, H = 4, 64, 64
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (T, N, H)).astype(np.float32))
    w1 = rng.normal(0, 0.3, (H, H)).astype(np.float32)
    parts = [w1, np.zeros((H, H)), np.eye(H), np.zeros((H, H)),
             np.zeros(H), np.zeros(H), np.zeros(H), np.zeros(H)]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in parts])
                            .astype(np.float32))
    state = torch.zeros(2, N, H)
    op = torch_reg.get("RNN")
    params = op.parse_params(dict(state_size=H, num_layers=2,
                                  mode="rnn_relu", p=p))
    first = torch.relu(x @ torch.from_numpy(w1).T)
    gen = torch.Generator().manual_seed(seed)
    (out,), _ = op.apply(params, torch_reg.OpContext(is_train=is_train,
                                                     rng=gen), x, flat, state)
    return first, out


def test_rnn_dropout_moments_and_determinism():
    """Inverted dropout between layers: about ``p`` of the live units
    dropped, the rest scaled by ``1 / (1 - p)`` (mean kept); one seed
    gives one mask, another seed another; no dropout in inference.  The
    masks differ from the JAX package's (a torch generator against a
    threefry key), as Dropout's do."""
    p = 0.3
    first, out = _dropout_probe(p, seed=5)
    live = first > 0
    dropped = (out[live] == 0).float().mean().item()
    assert abs(dropped - p) < 0.02, dropped
    kept = out[live] != 0
    torch.testing.assert_close(out[live][kept], first[live][kept] / (1 - p),
                               rtol=1e-5, atol=1e-6)
    assert abs(out.mean().item() / first.mean().item() - 1) < 0.03
    _, again = _dropout_probe(p, seed=5)
    _, other = _dropout_probe(p, seed=6)
    assert torch.equal(out, again) and not torch.equal(out, other)
    _, infer = _dropout_probe(p, seed=5, is_train=False)
    torch.testing.assert_close(infer, first, rtol=1e-6, atol=1e-6)
    op = torch_reg.get("RNN")
    assert op.uses_rng and not op.rng_in_eval


SLICE_CASES = [
    ("split_axis1", "SliceChannel", {"num_outputs": 4}, (3, 8)),
    ("split_alias", "split", {"num_outputs": 3, "axis": 0}, (6, 2, 5)),
    ("split_negative_axis", "SliceChannel",
     {"num_outputs": 2, "axis": -1}, (2, 3, 4)),
    ("split_squeeze", "SliceChannel",
     {"num_outputs": 5, "axis": 1, "squeeze_axis": True}, (2, 5, 3)),
    ("split_json_strings", "SliceChannel",
     {"num_outputs": "2", "axis": "2", "squeeze_axis": "False"}, (2, 3, 4)),
]


@pytest.mark.parametrize("name,params,shape", [c[1:] for c in SLICE_CASES],
                         ids=[c[0] for c in SLICE_CASES])
def test_slice_channel_matches_mxnet_tpu(name, params, shape):
    x = np.random.RandomState(0).normal(0, 1, shape).astype(np.float32)
    jo, jg, to, tg = _both(name, params, [x])
    assert len(to) == len(jo) == int(params["num_outputs"])
    for t, j in zip(to + tg, jo + jg):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    jop, top = jax_reg.get(name), torch_reg.get(name)
    _, j_out, _ = jop.infer_shape_generic(jop.parse_params(dict(params)),
                                          [shape])
    _, t_out, _ = top.infer_shape_generic(top.parse_params(dict(params)),
                                          [shape])
    assert [tuple(s) for s in t_out] == [tuple(s) for s in j_out]


def test_slice_channel_uneven_split_raises():
    top = torch_reg.get("SliceChannel")
    with pytest.raises(Exception, match="equal parts"):
        top.apply(top.parse_params({"num_outputs": 3}),
                  torch_reg.OpContext(), torch.zeros(2, 4))


@pytest.mark.parametrize("cond_kind", ["float", "int", "broadcast"])
def test_where_matches_mxnet_tpu(cond_kind):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (3, 4)).astype(np.float32)
    y = rng.normal(0, 1, (3, 4)).astype(np.float32)
    if cond_kind == "float":
        cond = (rng.uniform(size=(3, 4)) > 0.5) * rng.uniform(0.5, 2, (3, 4))
        cond = cond.astype(np.float32)
    elif cond_kind == "int":
        cond = rng.randint(-1, 2, (3, 4)).astype(np.int32)
    else:
        cond = np.array([[1.0], [0.0], [2.0]], dtype=np.float32)
    jo, jg, to, tg = _both("where", {}, [cond, x, y])
    np.testing.assert_array_equal(to[0], jo[0])
    # the condition gets no gradient: zeros in the JAX package, none here
    assert tg[0] is None or not tg[0].any()
    assert not np.asarray(jg[0]).any()
    for t, j in zip(tg[1:], jg[1:]):
        np.testing.assert_array_equal(t, j)
