"""The port's fused Trainer (``mxnet_tpu_torch.parallel.Trainer``) on the
CPU, against the JAX package's ``mxnet_tpu.parallel.Trainer``: the same
symbol, the same initial weights (moved across by
``params_from_mxnet_tpu``) and the same numpy batches through both.

On the CPU the port's step runs eagerly (the CUDA-graph capture is the
card's, checked by ``chip_smoke.py``)."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models
from mxnet_tpu.parallel import Trainer as JaxTrainer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.parallel import Trainer, make_update_fn

# float32 on both sides, products and sums in another order: parameters
# and outputs agree to ~1e-6 after a few steps, a wrong rule or gradient
# is off by 1e-2 or more
REL_TOL = 1e-5
# bfloat16 compute on both sides, rounded at different places: one step's
# parameter deltas were 1.9e-2 apart at worst (l0_ln1_gamma, measured on
# the CPU)
BF16_REL_TOL = 5e-2
# ... while the port's bfloat16 step is a median 1.1e-2 (7e-3 at least)
# from its own float32 step, which float32 rounding alone would leave
# ~1e-6 apart: a step that ignored compute_dtype falls below this
BF16_MIN_GAP = 1e-3

LM = dict(num_classes=31, seq_len=16, num_hidden=32, num_heads=2,
          num_layers=2)
BATCH = 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _lm(pkg):
    if pkg == "jax":
        return jax_models.get_symbol("transformer", **LM)
    return mt.models.transformer.get_symbol(**LM)


def _mlp(m):
    data = m.sym.Variable("data")
    h = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = m.sym.Activation(h, act_type="relu")
    h = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(h, name="softmax")


def _lm_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n, BATCH, LM["seq_len"])
    return [{"data": x, "softmax_label": y} for x, y in zip(
        rng.randint(0, LM["num_classes"], shape).astype("f"),
        rng.randint(0, LM["num_classes"], shape).astype("f"))]


def _mlp_batches(n, batch=8, seed=1):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(batch, 10).astype("f"),
             "softmax_label": rng.randint(0, 4, batch).astype("f")}
            for _ in range(n)]


def _shapes(batch):
    return ({"data": batch["data"].shape},
            {"softmax_label": batch["softmax_label"].shape})


def _jax_run(sym, opt, batches, **kw):
    """The JAX Trainer over ``batches``: (initial params as numpy, its
    outputs per step, its final params as numpy)."""
    t = JaxTrainer(sym, opt, **kw)
    t.bind(*_shapes(batches[0]))
    t.init_params(mx.init.Xavier())
    arg, _ = t.get_params()
    init = {k: v.asnumpy() for k, v in arg.items()}
    outs = [t.step(b)[0].asnumpy() for b in batches]
    arg, _ = t.get_params()
    return init, outs, {k: v.asnumpy() for k, v in arg.items()}


def _port_trainer(sym, opt, batch, init, **kw):
    with mt.cpu():
        t = Trainer(sym, opt, **kw)
    t.bind(*_shapes(batch))
    arg, aux = params_from_mxnet_tpu(init, {})
    t.init_params(arg_params=arg, aux_params=aux)
    return t


def _port_run(sym, opt, batches, init, **kw):
    t = _port_trainer(sym, opt, batches[0], init, **kw)
    outs = [t.step(b)[0].asnumpy() for b in batches]
    return t, outs, {k: v.data.numpy() for k, v in t.params.items()}


def _key_bias(name):
    """The key third of an attention's fused qkv bias: softmax does not
    change when every score of a row moves by one constant, so its
    gradient is 0 but for rounding (~1e-7 of the query bias's)."""
    h = LM["num_hidden"]
    return slice(h, 2 * h) if name.endswith("_attn_qkv_bias") else None


def test_float32_adam_matches_the_jax_trainer():
    batches = _lm_batches(3)
    lr = 1e-3
    init, jax_outs, jax_params = _jax_run(
        _lm("jax"), mx.optimizer.Adam(learning_rate=lr,
                                      rescale_grad=1.0 / BATCH), batches)
    _, outs, params = _port_run(
        _lm("port"), mt.optimizer.Adam(learning_rate=lr,
                                       rescale_grad=1.0 / BATCH),
        batches, init)
    for got, want in zip(outs, jax_outs):
        assert _rel(got, want) < REL_TOL
    assert sorted(params) == sorted(jax_params)
    for name, want in jax_params.items():
        got, keys = params[name], _key_bias(name)
        if keys is not None:
            # Adam divides the key bias's rounding noise by its own size,
            # so each side takes steps of up to lr there, in the noise's
            # direction: bounded, not compared
            for side in (got, want):
                assert np.abs(side[keys] - init[name][keys]).max() \
                    <= lr * len(batches)
            got, want = np.delete(got, keys), np.delete(want, keys)
        assert _rel(got, want) < REL_TOL, name


def test_sgd_momentum_matches_the_jax_trainer():
    batches = _lm_batches(3, seed=1)
    kw = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / BATCH)
    init, jax_outs, jax_params = _jax_run(
        _lm("jax"), mx.optimizer.SGD(**kw), batches)
    _, outs, params = _port_run(_lm("port"), mt.optimizer.SGD(**kw),
                                batches, init)
    for got, want in zip(outs, jax_outs):
        assert _rel(got, want) < REL_TOL
    for name, want in jax_params.items():
        assert _rel(params[name], want) < REL_TOL, name


def test_bfloat16_compute_step_matches_the_jax_trainer():
    """One SGD step with bfloat16 compute: the parameter deltas (lr times
    the float32 master gradients) of both packages agree to the bfloat16
    tolerance, and the master weights stay float32."""
    batches = _lm_batches(1, seed=2)
    kw = dict(learning_rate=0.5, rescale_grad=1.0 / BATCH)
    init, jax_outs, jax_params = _jax_run(
        _lm("jax"), mx.optimizer.SGD(**kw), batches,
        compute_dtype="bfloat16")
    t, outs, params = _port_run(_lm("port"), mt.optimizer.SGD(**kw),
                                batches, init, compute_dtype="bfloat16")
    _, _, f32_params = _port_run(_lm("port"), mt.optimizer.SGD(**kw),
                                 batches, init)
    assert all(v.dtype == torch.float32 for v in t.params.values())
    assert outs[0].dtype == np.float32
    assert _rel(outs[0], jax_outs[0]) < BF16_REL_TOL
    gaps = []
    for name, want in jax_params.items():
        delta = params[name] - init[name]
        assert _rel(delta, want - init[name]) < BF16_REL_TOL, name
        gaps.append(_rel(delta, f32_params[name] - init[name]))
    # the products really ran in bfloat16: the step is further from the
    # port's float32 step than float32 rounding moves it
    assert np.median(gaps) > BF16_MIN_GAP, gaps


def test_bfloat16_products_sum_in_float32_inside_the_step(monkeypatch):
    """The step sums bfloat16 products in float32 (cuBLAS's reduced-
    precision flags off) while it runs, and gives the caller's flags
    back after."""
    mm = torch.backends.cuda.matmul
    monkeypatch.setattr(mm, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(mm, "allow_fp16_reduced_precision_reduction", True)
    seen = []
    forward = Trainer._forward

    def spy(self, *args):
        seen.append((mm.allow_bf16_reduced_precision_reduction,
                     mm.allow_fp16_reduced_precision_reduction))
        return forward(self, *args)

    monkeypatch.setattr(Trainer, "_forward", spy)
    batch = _lm_batches(1)[0]
    with mt.cpu():
        t = Trainer(_lm("port"), mt.optimizer.SGD(),
                    compute_dtype="bfloat16")
    t.bind(*_shapes(batch))
    t.init_params(mt.init.Xavier())
    t.step(batch)
    t.forward(batch)
    assert seen == [(False, False)] * 2
    assert mm.allow_bf16_reduced_precision_reduction
    assert mm.allow_fp16_reduced_precision_reduction


def test_grad_accum_matches_the_jax_trainer_and_one_batch():
    """``grad_accum=2`` sums two microbatches' float32 gradients into one
    update: equal to the JAX package's ``grad_accum=2`` and to the port's
    one-batch step; outputs come back in batch order."""
    batches = _mlp_batches(2)
    kw = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8)
    init, jax_outs, jax_params = _jax_run(
        _mlp(mx), mx.optimizer.SGD(**kw), batches, grad_accum=2)
    _, outs, params = _port_run(_mlp(mt), mt.optimizer.SGD(**kw), batches,
                                init, grad_accum=2)
    _, one_outs, one_params = _port_run(_mlp(mt), mt.optimizer.SGD(**kw),
                                        batches, init)
    for got, want, one in zip(outs, jax_outs, one_outs):
        assert _rel(got, want) < REL_TOL and _rel(got, one) < REL_TOL
    for name, want in jax_params.items():
        assert _rel(params[name], want) < REL_TOL, name
        assert _rel(params[name], one_params[name]) < REL_TOL, name


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_grad_accum_refuses_a_head_that_is_not_batch_major(pkg):
    """The LM's head is (batch * seq_len, vocab): both packages refuse to
    stitch it from microbatches."""
    m, trainer = (mx, JaxTrainer) if pkg == "jax" else (mt, Trainer)
    with mt.cpu():
        t = trainer(_lm(pkg), m.optimizer.SGD(), grad_accum=2)
    with pytest.raises(Exception, match="batch-major"):
        t.bind(*_shapes(_lm_batches(1)[0]))


def _nan_batch(batch):
    return dict(batch, data=np.full_like(batch["data"], np.nan))


def test_sentinel_skips_a_nan_batch_like_the_jax_trainer():
    """``sentinel="skip"``: a NaN batch leaves params and optimizer state
    bitwise as they were, counts one skip and holds the update counter;
    the next clean step's update equals the JAX package's."""
    clean = _mlp_batches(2)
    batches = [clean[0], _nan_batch(clean[0]), clean[1]]
    kw = dict(learning_rate=1e-2, rescale_grad=1.0 / 8)
    jax_t = JaxTrainer(_mlp(mx), mx.optimizer.Adam(**kw), sentinel="skip")
    jax_t.bind(*_shapes(clean[0]))
    jax_t.init_params(mx.init.Xavier())
    init = {k: v.asnumpy() for k, v in jax_t.get_params()[0].items()}
    jax_outs = [jax_t.step(b)[0].asnumpy() for b in batches]
    t = _port_trainer(_mlp(mt), mt.optimizer.Adam(**kw), clean[0], init,
                      sentinel="skip")
    t.step(batches[0])
    before = {k: v.clone() for k, v in t.params.items()}
    state = [v.clone() for s in t.opt_state.values() for v in s]
    out = t.step(batches[1])[0].asnumpy()
    assert np.isnan(out).all()
    for k, v in t.params.items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(
        state, [v for s in t.opt_state.values() for v in s]))
    assert t.sentinel_skips == jax_t.sentinel_skips == 1
    assert int(t._sent["t"]) == 1 and int(t._sent["consec"]) == 1
    last = t.step(batches[2])[0].asnumpy()
    assert _rel(last, jax_outs[2]) < REL_TOL
    assert int(t._sent["t"]) == 2 and int(t._sent["consec"]) == 0
    for k, v in jax_t.get_params()[0].items():
        assert _rel(t.params[k].numpy() - before[k].numpy(),
                    v.asnumpy() - before[k].numpy()) < REL_TOL, k


def test_sentinel_abort_raises_after_max_skips():
    batch = _mlp_batches(1)[0]
    with mt.cpu():
        t = Trainer(_mlp(mt), mt.optimizer.SGD(learning_rate=0.1),
                    sentinel="abort", sentinel_max_skips=2)
    t.bind(*_shapes(batch))
    t.init_params(mt.init.Xavier())
    t.step(batch)
    t.step(_nan_batch(batch))            # one skip: below the threshold
    with pytest.raises(mt.MXNetError, match="2 consecutive non-finite"):
        t.step(_nan_batch(batch))
    assert t.sentinel_skips == 2


def test_loss_scale_with_a_softmax_output_head_warns_and_is_inert(caplog):
    """SoftmaxOutput injects its gradient and drops the seeds, so a loss
    scale cannot reach the backward: the trainer warns and trains exactly
    as without one."""
    batches = _mlp_batches(2)
    init = _jax_run(_mlp(mx), mx.optimizer.SGD(), batches[:1])[0]
    runs = []
    for scale in (None, 128.0):
        with caplog.at_level(logging.WARNING, logger="mxtpu.trainer"):
            t, outs, params = _port_run(
                _mlp(mt), mt.optimizer.SGD(learning_rate=0.1), batches,
                init, sentinel="skip", loss_scale=scale)
        runs.append((outs, params))
    assert any("INERT" in r.getMessage() for r in caplog.records)
    assert t.loss_scale_value == 128.0
    (outs0, params0), (outs1, params1) = runs
    for a, b in zip(outs0, outs1):
        np.testing.assert_array_equal(a, b)
    for k in params0:
        np.testing.assert_array_equal(params0[k], params1[k])


def test_loss_scale_reaches_a_head_that_takes_its_seed():
    """With ``out_grad=True`` the head multiplies its gradient by the seed,
    so the scale rides the backward and is divided out of the float32
    gradients: a fixed and a dynamic scale train as the JAX package's
    do, and the dynamic scale grows after ``ls_growth_interval`` clean
    steps."""
    def mlp(m):
        data = m.sym.Variable("data")
        h = m.sym.FullyConnected(data, num_hidden=4, name="fc1")
        return m.sym.SoftmaxOutput(h, name="softmax", out_grad=True)
    batches = _mlp_batches(3)
    kw = dict(learning_rate=0.1, rescale_grad=1.0 / 8)
    for scale in (64.0, "dynamic"):
        opts = dict(sentinel="skip", loss_scale=scale, ls_growth_interval=2)
        init, jax_outs, jax_params = _jax_run(
            mlp(mx), mx.optimizer.SGD(**kw), batches, **opts)
        t, outs, params = _port_run(mlp(mt), mt.optimizer.SGD(**kw),
                                    batches, init, **opts)
        for name, want in jax_params.items():
            assert _rel(params[name], want) < REL_TOL, (scale, name)
        want_scale = 64.0 if scale == 64.0 else 2.0 ** 16
        assert t.loss_scale_value == want_scale


def test_optimizer_state_round_trip():
    """``get_opt_states``/``set_opt_states``: the step count, the Adam
    moments and the sentinel counters carry over, and both trainers take
    the same next step; a corrupt blob raises."""
    batches = _mlp_batches(3)
    init = _jax_run(_mlp(mx), mx.optimizer.SGD(), batches[:1])[0]
    opt = dict(learning_rate=1e-2, rescale_grad=1.0 / 8)
    a = _port_trainer(_mlp(mt), mt.optimizer.Adam(**opt), batches[0], init,
                      sentinel="skip")
    a.step(batches[0])
    a.step(_nan_batch(batches[1]))
    blob = a.get_opt_states()
    b = _port_trainer(_mlp(mt), mt.optimizer.Adam(**opt), batches[0], init,
                      sentinel="skip")
    b.set_params({k: mt.nd.NDArray(v) for k, v in a.params.items()})
    b.set_opt_states(blob)
    assert b.num_update == a.num_update == 2
    assert b.sentinel_skips == 1 and int(b._sent["t"]) == 1
    for name in a.opt_state:
        for x, y in zip(a.opt_state[name], b.opt_state[name]):
            assert torch.equal(x, y)
    a.step(batches[2])
    b.step(batches[2])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    with pytest.raises(mt.MXNetError, match="truncated or corrupt"):
        b.set_opt_states(blob[:20])


def test_outputs_of_a_step_stay_valid_after_the_next():
    batches = _mlp_batches(2)
    init = _jax_run(_mlp(mx), mx.optimizer.SGD(), batches[:1])[0]
    t = _port_trainer(_mlp(mt), mt.optimizer.SGD(learning_rate=0.5),
                      batches[0], init)
    first = t.step(batches[0])[0]
    kept = first.asnumpy().copy()
    second = t.step(batches[0])[0]
    np.testing.assert_array_equal(first.asnumpy(), kept)
    assert not np.array_equal(second.asnumpy(), kept)


def test_lr_scheduler_and_lr_reach_the_step():
    """The step reads lr from the scheduler at each update (through one
    device scalar, rewritten only when lr changes), as the JAX package's
    does."""
    batches = _mlp_batches(4)

    def opt(m):
        return m.optimizer.SGD(learning_rate=0.4, lr_scheduler=m.lr_scheduler
                               .FactorScheduler(step=2, factor=0.5))
    init, jax_outs, jax_params = _jax_run(_mlp(mx), opt(mx), batches)
    _, outs, params = _port_run(_mlp(mt), opt(mt), batches, init)
    for name, want in jax_params.items():
        assert _rel(params[name], want) < REL_TOL, name


def test_make_update_fn_decays_weights_not_biases():
    """wd defaults to 1 for ``*_weight`` and ``*_gamma`` and to 0 for the
    rest, scaled by lr/wd multipliers."""
    sgd = mt.optimizer.SGD(learning_rate=1.0, wd=0.1)
    sgd.set_lr_mult({"b_bias": 2.0})
    names = ["a_weight", "b_bias", "c_gamma"]
    init_fn, update_fn = make_update_fn(sgd, names)
    params = {n: torch.ones(2) for n in names}
    grads = {n: torch.zeros(2) for n in names}
    new, state = update_fn(params, grads, init_fn(params),
                           torch.tensor(1.0), torch.tensor(1))
    assert state == {n: None for n in names}
    assert torch.allclose(new["a_weight"], torch.full((2,), 0.9))
    assert torch.equal(new["b_bias"], torch.ones(2))
    assert torch.allclose(new["c_gamma"], torch.full((2,), 0.9))
    assert all(torch.equal(p, torch.ones(2)) for p in params.values())


@pytest.mark.parametrize("option", [
    dict(param_specs={"fc1_weight": ("model",)}), dict(integrity="fp"),
    dict(plan={}), dict(integrity_period=10), dict(mesh=object()),
    dict(zero=1), dict(remat="dots"), dict(donate_batch=True),
    dict(grad_dtype="bf16")])
def test_options_of_later_slices_raise(option):
    """What waits for a later slice raises naming it; a mesh must be the
    port's; the data-parallel knobs, remat and the integrity knobs are
    taken (zero=1 and the bfloat16 wire inert without a mesh, as in the
    JAX package; ``integrity_period`` on one device too)."""
    taken = ("zero", "remat", "donate_batch", "grad_dtype", "integrity",
             "integrity_period")
    with mt.cpu():
        if set(option) & set(taken):
            t = Trainer(_mlp(mt), mt.optimizer.SGD(), **option)
            assert not (t._zero_on or t._lowp_on or t._comm)
            assert t.integrity == option.get("integrity", "off")
            assert t.integrity_period == option.get("integrity_period", 100)
            return
        with pytest.raises(mt.MXNetError,
                           match="slice|item 7|not a parallel.Mesh"):
            Trainer(_mlp(mt), mt.optimizer.SGD(), **option)


@pytest.mark.parametrize("knob", ["ctor", "env"])
def test_donated_batches_are_given_up_and_never_written(monkeypatch, knob):
    """``donate_batch`` (the argument, or ``MXTPU_DONATE_BATCH`` as a
    Module's trainer reads it): two batches that are rows of one dataset
    tensor, fed in turn, stay as they were, and a batch tensor that is
    the whole of its storage is emptied after its step; the parameters
    equal a trainer's that keeps every batch."""
    batches = _mlp_batches(2)
    init = _jax_run(_mlp(mx), mx.optimizer.SGD(), batches[:1])[0]
    data = torch.from_numpy(np.concatenate([b["data"] for b in batches]))
    label = torch.from_numpy(np.concatenate(
        [b["softmax_label"] for b in batches]))
    kept = (data.clone(), label.clone())
    params = {}
    for donate in (False, True):
        if knob == "env":
            monkeypatch.setenv("MXTPU_DONATE_BATCH", "1" if donate else "0")
        kw = {"donate_batch": donate} if knob == "ctor" else {}
        t = _port_trainer(_mlp(mt), mt.optimizer.SGD(learning_rate=0.5,
                                                     momentum=0.9),
                          batches[0], init, **kw)
        assert t.donate_batch is donate
        for step in range(4):
            rows = slice(8 * (step % 2), 8 * (step % 2) + 8)
            t.step({"data": data[rows], "softmax_label": label[rows]})
        whole = {"data": data[:8].clone(), "softmax_label": label[:8].clone()}
        t.step(whole)
        assert all(v.numel() == (0 if donate else 8 * (10 if n == "data"
                                                       else 1))
                   for n, v in whole.items())
        if donate:
            with pytest.raises(mt.MXNetError, match="donate_batch"):
                t.step(whole)
        params[donate] = {k: v.clone() for k, v in t.params.items()}
        assert torch.equal(data, kept[0]) and torch.equal(label, kept[1])
    for k in params[False]:
        assert torch.equal(params[True][k], params[False][k]), k


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        Trainer(_mlp(mt), mt.optimizer.SGD())
