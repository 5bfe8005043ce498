"""The port's Module on its fused path (``parallel.Trainer`` under
``Module.fit``), on the CPU with ``MXTPU_MODULE_FUSED=always``, against
the JAX package's fused Module; the classic path under ``never``."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import Module

LM = dict(num_classes=31, seq_len=16, num_hidden=32, num_heads=2,
          num_layers=1)
# float32 on both sides, sums in another order (the JAX package's fused
# Module splits each batch over the test's 8 virtual CPU devices)
REL_TOL = 1e-5


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "always")


def _cyclic(n=128, seed=0):
    """Memorizable next-token data: sequences counting up modulo 31."""
    rng = np.random.RandomState(seed)
    seqs = np.stack([np.arange(i, i + 17) % 31
                     for i in rng.randint(0, 31, n)])
    return seqs[:, :16].astype("f"), seqs[:, 1:].astype("f")


def _port_iter(x, y, **kw):
    with mt.cpu():
        return mt.io.NDArrayIter(x, y, batch_size=32, **kw)


def _init_params(sym, seed=3):
    shapes, _, _ = sym.infer_shape(data=(32, 16), softmax_label=(32, 16))
    rng = np.random.RandomState(seed)
    return {n: (rng.normal(0, 0.2, s) if not n.endswith("_gamma")
                else np.ones(s)).astype("f")
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _accuracy(mod, x, y):
    correct = 0
    for b in _port_iter(x, y):
        mod.forward(b, is_train=False)
        out = mod.get_outputs()[0].asnumpy().reshape(32, 16, 31)
        correct += (out.argmax(-1) == b.label[0].asnumpy()).sum()
    return correct / y.size


def test_transformer_lm_learns_through_the_fused_trainer(fused):
    """``tests/test_models.py::test_transformer_lm_learns`` through the
    port's fused path: the step is the Trainer's."""
    x, y = _cyclic()
    with mt.cpu():
        sym = mt.models.transformer.get_symbol(**LM)
        mod = mt.mod.Module(sym)
        metric = mt.metric.Perplexity(None)
        mod.fit(_port_iter(x, y, shuffle=True), num_epoch=12,
                optimizer="adam", optimizer_params={"learning_rate": 3e-3},
                initializer=mt.init.Xavier(factor_type="in", magnitude=2.0),
                eval_metric=metric)
    assert mod._trainer is not None and mod._exec_group is None
    assert mod._trainer.num_update == 48
    assert metric.get()[1] < 2.0
    assert _accuracy(mod, x, y) > 0.9


def _fit_both(num_epoch, n, seed):
    """``Module.fit`` on the port's fused path, and on the JAX package's
    fused Module the same epochs' batches stepped one by one by
    ``forward``/``update`` (its ``fit`` re-creates the optimizer state at
    an epoch's end; ROADMAP §C), from the same initial weights, SGD with
    momentum: (the JAX package's params, the port's)."""
    x, y = _cyclic(n=n, seed=seed)
    jsym = jax_models.get_symbol("transformer", **LM)
    init = _init_params(jsym)
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    jit = mx.io.NDArrayIter(x, y, batch_size=32)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in init.items()})
    jmod.init_optimizer(**opt)
    assert jmod._trainer is not None
    for _ in range(num_epoch):
        for batch in jit:
            jmod.forward(batch, is_train=True)
            jmod.update()
        jit.reset()
    with mt.cpu():
        mod = Module(mt.models.transformer.get_symbol(**LM))
        mod.fit(_port_iter(x, y), num_epoch=num_epoch,
                arg_params={k: mt.nd.array(v) for k, v in init.items()},
                eval_metric=mt.metric.Perplexity(None), **opt)
    assert mod._trainer is not None
    want, _ = jmod.get_params()
    got, _ = mod.get_params()
    assert sorted(got) == sorted(want)
    return ({k: v.asnumpy() for k, v in want.items()},
            {k: v.asnumpy() for k, v in got.items()})


def test_one_epoch_matches_the_jax_fused_module(fused):
    """From the same initial weights, one epoch of ``Module.fit`` on both
    packages' fused paths ends at the same parameters."""
    want, got = _fit_both(1, n=128, seed=1)
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= REL_TOL * np.linalg.norm(w), k


def test_two_epochs_match_the_jax_fused_module(fused):
    """Two epochs: at the first one's end the port's ``fit`` writes the
    trained values back with ``set_params`` and keeps the optimizer state
    (here the momentum), as the classic path does: it ends where the JAX
    package's fused step, run over the same batches, ends.  An epoch end
    that re-created the momentum, as the JAX package's ``fit`` does, ends
    a median 0.3 apart by relative norm."""
    want, got = _fit_both(2, n=64, seed=2)
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= REL_TOL * np.linalg.norm(w), k


def test_never_keeps_the_classic_path(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "never")
    x, y = _cyclic(n=64)
    with mt.cpu():
        mod = Module(mt.models.transformer.get_symbol(**LM),
                     compute_dtype="bfloat16")
        mod.fit(_port_iter(x, y), num_epoch=1, optimizer="adam")
    assert mod._trainer is None and mod._exec_group is not None
    assert mod.sentinel_skips == 0


def test_auto_fuses_only_a_gpu_context():
    x, y = _cyclic(n=64)
    with mt.cpu():
        mod = Module(mt.models.transformer.get_symbol(**LM))
        mod.fit(_port_iter(x, y), num_epoch=1, optimizer="adam")
    assert mod._trainer is None and mod._exec_group is not None


def test_compute_dtype_trains_through_the_fused_trainer(fused):
    """``compute_dtype="bfloat16"``: the fused step computes in bfloat16
    over float32 master weights, and the LM still learns."""
    x, y = _cyclic()
    with mt.cpu():
        mod = Module(mt.models.transformer.get_symbol(**LM),
                     compute_dtype="bfloat16")
        metric = mt.metric.Perplexity(None)
        mod.fit(_port_iter(x, y, shuffle=True), num_epoch=12,
                optimizer="adam", optimizer_params={"learning_rate": 3e-3},
                initializer=mt.init.Xavier(factor_type="in", magnitude=2.0),
                eval_metric=metric)
    trainer = mod._trainer
    assert trainer.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in trainer.params.values())
    assert metric.get()[1] < 3.0
    assert _accuracy(mod, x, y) > 0.8


class _NoRule(mt.optimizer.SGD):
    """An optimizer with its own per-weight update and no pure rule."""

    _rule = mt.optimizer.Optimizer._rule


def test_an_optimizer_without_a_rule_trains_on_the_classic_path(fused,
                                                                caplog):
    x, y = _cyclic(n=64)
    with mt.cpu(), caplog.at_level(logging.WARNING):
        mod = Module(mt.models.transformer.get_symbol(**LM))
        mod.fit(_port_iter(x, y), num_epoch=1,
                optimizer=_NoRule(learning_rate=0.1, rescale_grad=1 / 32))
    assert any("no fused-step rule" in r.getMessage()
               for r in caplog.records)
    assert mod._trainer is None and mod._exec_group is not None


def test_optimizer_states_and_sentinel_through_the_module(fused, monkeypatch,
                                                          tmp_path):
    """The fused path saves and loads the Trainer's optimizer state
    (``.states``), and reports the sentinel's skips."""
    monkeypatch.setenv("MXTPU_SENTINEL", "skip")
    x, y = _cyclic(n=64)
    with mt.cpu():
        sym = mt.models.transformer.get_symbol(**LM)
        mod = Module(sym)
        mod.fit(_port_iter(x, y), num_epoch=1, optimizer="adam")
        # a step after the epoch's end: the state saved below is the
        # one of the third update
        mod.forward(next(iter(_port_iter(x, y))), is_train=True)
        mod.update()
    assert mod.sentinel_skips == 0
    assert any(bool(s.any()) for v in mod._trainer.opt_state.values()
               for s in v)
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    with mt.cpu():
        mod2 = Module.load(prefix, 1, load_optimizer_states=True)
        it = _port_iter(x, y)
    mod2.bind(it.provide_data, it.provide_label)
    mod2.init_optimizer(optimizer="adam")
    a, b = mod._trainer, mod2._trainer
    assert b.num_update == a.num_update == 3
    for name in a.opt_state:
        for s, t in zip(a.opt_state[name], b.opt_state[name]):
            assert torch.equal(s, t)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k])


def test_one_fused_step_matches_one_classic_step(monkeypatch):
    """From the same weights and batch, one Adam step on the fused path
    and one on the classic path agree to 1e-5: the same graph and
    gradients, while the fused rule forms Adam's bias correction in
    float32 (as the JAX package's rule does) and the classic in-place
    update in float64, 6.4e-6 apart at t = 1."""
    x, y = _cyclic(n=32, seed=4)
    with mt.cpu():
        sym = mt.models.transformer.get_symbol(**LM)
    init = _init_params(sym)
    params = []
    for policy in ("always", "never"):
        monkeypatch.setenv("MXTPU_MODULE_FUSED", policy)
        with mt.cpu():
            mod = Module(sym)
            it = _port_iter(x, y)
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params={k: mt.nd.array(v)
                                        for k, v in init.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 1e-2})
        assert (mod._trainer is not None) == (policy == "always")
        mod.forward(next(iter(it)), is_train=True)
        mod.backward()
        mod.update()
        params.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    fused, classic = params
    for k, want in classic.items():
        assert np.linalg.norm(fused[k] - want) \
            <= REL_TOL * np.linalg.norm(want), k
