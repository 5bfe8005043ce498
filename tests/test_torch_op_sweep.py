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
the case's ``check`` alone.  The ops the port does not register are
exactly ROADMAP item 8's families, and no case of another op is left
out."""
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

# ROADMAP item 8: the vision, contrib (MultiBox*, Proposal, fft,
# count_sketch) and CTC families and _imdecode, under every name
ITEM_8 = {
    "BilinearSampler", "Correlation", "GridGenerator", "ROIPooling",
    "SpatialTransformer", "_imdecode", "MultiBoxPrior", "MultiBoxTarget",
    "MultiBoxDetection", "Proposal", "_contrib_MultiBoxPrior",
    "_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
    "_contrib_Proposal", "count_sketch", "_contrib_count_sketch", "fft",
    "ifft", "_contrib_fft", "_contrib_ifft", "WarpCTC"}


def _registered(name):
    return name in treg._REGISTRY or name in treg._ALIASES


RUN = [c for c in TABLE.CASES if c["kind"] != "imp" and _registered(c["op"])]


def _sampler(case):
    return treg.get(case["op"]).uses_rng and not case["loc"]


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (what, i)
            continue
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg="%s[%d]" % (what, i))


@pytest.mark.parametrize("case", RUN, ids=[c["id"] for c in RUN])
def test_case_matches_jax(case):
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
