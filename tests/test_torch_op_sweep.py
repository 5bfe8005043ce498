"""The JAX package's op-sweep case table (``tests/test_op_sweep.py``, read
in place by path, unedited) driven through both packages' op bodies on
the CPU: every case whose op the port registers, forward and backward
(``jax.vjp`` beside ``torch.autograd.grad``, the same random head
gradients; no finite differences), outputs, new aux states and every
floating input's gradient.

Tolerance: each case's own.  A gradient case (``G``) states ``rtol`` and
``atol`` for its finite-difference check (5e-2 / 5e-3 unless it says
more); a forward case (``F``) is checked to 1e-3 / 1e-4, as
``check_symbolic_forward`` checks it there; both are applied to the port
against the JAX op, forward and backward.  A forward case's own contract
(``fwd`` or ``check``) is applied to the port's output too.  Samplers draw
from other generators than the JAX package's, so theirs is checked by
the case's ``check`` alone.  The port registers every op of the JAX registry, so every case runs,
the imperative ``_imdecode`` case through both packages' ``mx.nd``.
Three cases more pin the order rules where scores or maxima tie:
ROIPooling's gradient splits evenly among tied maxima, Proposal's top-k
takes the lower index first, and MultiBoxDetection's NMS and sort keep
index order among equal scores."""
import importlib.util
import os

import numpy as np
import pytest

from mxnet_tpu.op import registry as jreg
from mxnet_tpu_torch.op import registry as treg

from torch_parity import jax_apply, port_apply

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "test_op_sweep.py")
_SPEC = importlib.util.spec_from_file_location("_op_sweep_table", _PATH)
TABLE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TABLE)

# the JAX registry's ops the port does not register: none
ITEM_8 = set()


def _registered(name):
    return name in treg._REGISTRY or name in treg._ALIASES


RUN = [c for c in TABLE.CASES if _registered(c["op"])]


def _sampler(case):
    return treg.get(case["op"]).uses_rng and not case["loc"]


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (what, i)
            continue
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg="%s[%d]" % (what, i))


def _png(img):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def _port_imdecode():
    """The table's ``_imdecode`` case through the port's ``mx.nd``."""
    import mxnet_tpu_torch as mt
    img = (np.arange(4 * 6 * 3) % 255).astype("uint8").reshape(4, 6, 3)
    with mt.cpu():
        out = mt.nd._imdecode(mt.nd.array(_png(img).astype("f")))
    np.testing.assert_array_equal(out.asnumpy().astype("uint8"), img)


PORT_IMPERATIVE = {"_imdecode": _port_imdecode}


@pytest.mark.parametrize("case", RUN, ids=[c["id"] for c in RUN])
def test_case_matches_jax(case):
    if case["kind"] == "imp":
        case["run"]()
        PORT_IMPERATIVE[case["op"]]()
        return
    ins = [np.asarray(v, np.float32) for v in case["loc"].values()]
    aux = [np.asarray(v, np.float32) for v in (case["aux"] or {}).values()]
    params = dict(case["params"])
    is_train = case["kind"] == "grad"
    if case["kind"] == "grad":
        rtol, atol = case["rtol"], case["atol"]
    else:
        rtol, atol = 1e-3, 1e-4
    if _sampler(case):
        out, _, _ = port_apply(case["op"], params, ins, is_train=False)
        assert case["check"](out[0]), case["id"]
        return
    w_out, w_aux, w_grads, cots = jax_apply(case["op"], params, ins, aux,
                                            is_train, seed=1)
    g_out, g_aux, g_grads = port_apply(case["op"], params, ins, aux,
                                       is_train, cots)
    assert [o.shape for o in g_out] == [o.shape for o in w_out]
    _close(g_out, w_out, rtol, atol, case["id"] + " outputs")
    _close(g_aux, w_aux, rtol, atol, case["id"] + " aux")
    _close(g_grads, w_grads, rtol, atol, case["id"] + " gradients")
    if case["kind"] == "fwd":
        if case.get("fwd") is not None:
            want = case["fwd"](*ins)
            want = want if isinstance(want, (list, tuple)) else [want]
            _close(g_out, [np.asarray(w, np.float32) for w in want], rtol,
                   atol, case["id"] + " contract")
        else:
            assert case["check"](g_out[0]), case["id"]


def test_port_registers_every_op_but_item_8():
    """The JAX registry's names and aliases less the port's are exactly
    item 8's; the port registers nothing the JAX package lacks."""
    jax_names = set(jreg._REGISTRY) | set(jreg._ALIASES)
    port_names = set(treg._REGISTRY) | set(treg._ALIASES)
    dynamic = ("Custom[", "_Native[", "_NDArray[", "_Python[")
    jax_names = {n for n in jax_names if not n.startswith(dynamic)}
    assert jax_names - port_names == ITEM_8
    assert port_names <= jax_names


def test_cases_not_run_are_exactly_item_8():
    skipped = {c["op"] for c in TABLE.CASES} - {c["op"] for c in RUN}
    assert skipped == ITEM_8
    assert len(RUN) == len([c for c in TABLE.CASES
                            if c["op"] not in ITEM_8])


def _tie_rois():
    """Blocks of equal values, so every bin's maximum is tied."""
    data = np.repeat(np.repeat(np.arange(8, dtype=np.float32)
                               .reshape(1, 2, 2, 2), 3, axis=2), 3, axis=3)
    rois = np.array([[0, 0, 0, 5, 5], [0, 1, 1, 4, 5]], np.float32)
    return "ROIPooling", {"pooled_size": (2, 2), "spatial_scale": 1.0}, \
        [data, rois]


def _tie_proposal():
    """Every foreground score equal: the top-k and the NMS keep index
    order."""
    rng = np.random.default_rng(3)
    prob = np.full((1, 2, 4, 4), 0.5, np.float32)
    deltas = (rng.standard_normal((1, 4, 4, 4)) * 0.05).astype(np.float32)
    info = np.array([[32, 32, 1.0]], np.float32)
    return "Proposal", {"feature_stride": 8, "scales": "(2,)",
                        "ratios": "(1.0,)", "rpn_pre_nms_top_n": 10,
                        "rpn_post_nms_top_n": 6, "threshold": 0.5,
                        "rpn_min_size": 1, "output_score": True}, \
        [prob, deltas, info]


def _tie_detection():
    """Equal scores over overlapping boxes of two classes."""
    prob = np.array([[[0.2, 0.2, 0.2, 0.2],
                      [0.4, 0.4, 0.4, 0.1],
                      [0.4, 0.4, 0.4, 0.7]]], np.float32)
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.1, 0.52, 0.5],
                         [0.6, 0.6, 0.9, 0.9], [0.1, 0.1, 0.5, 0.5]]],
                       np.float32)
    loc = np.zeros((1, 16), np.float32)
    return "MultiBoxDetection", {"nms_threshold": 0.5}, \
        [prob, loc, anchors]


TIES = [_tie_rois, _tie_proposal, _tie_detection]


@pytest.mark.parametrize("make", TIES, ids=[f.__name__[5:] for f in TIES])
def test_ties_follow_the_jax_order(make):
    """Outputs exactly, gradients to 1e-6: at a tie the JAX op's order
    rule decides which element is kept or where a gradient goes."""
    name, params, ins = make()
    w_out, _, w_grads, cots = jax_apply(name, params, ins, (), True, seed=2)
    g_out, _, g_grads = port_apply(name, params, ins, (), True, cots)
    _close(g_out, w_out, 0, 0, name + " outputs")
    _close(g_grads, w_grads, 1e-6, 1e-6, name + " gradients")
