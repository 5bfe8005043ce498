"""The port's optimizers beyond SGD and Adam (ccSGD, NAG, SGLD, DCASGD,
AdaGrad, RMSProp plain and centered, AdaDelta, Ftrl) against the JAX
package's, on the CPU: each classic ``update`` against the JAX
``update``, each fused ``_rule`` (``parallel.Trainer`` under
``Module``) against its own classic path, and every state tree through
``Updater.get_states``/``set_states`` and the Trainer's states blob.

Tolerances, relative norms of the difference over three steps with wd,
clip, rescale and an lr multiplier: classic against the JAX package
1e-6 (measured: 8.3e-8 at worst, centered RMSProp; the JAX update forms
its scalars in float32, the port's classic path in float64 before the
product), fused against classic 1e-6 (the fused step reads lr as a
float32 device scalar and multiplies the lr multiplier in there; a wrong
rule or state is off by 1e-2 or more)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.parallel import Trainer
from mxnet_tpu_torch.parallel.trainer import _leaves

REL_TOL = 1e-6
COMMON = dict(learning_rate=0.05, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.8)
# name, its own arguments; every optimizer with a fused rule, and the
# state tree each keeps (None, one tensor, 1-, 2-, 3-tuples, (None, t))
CASES = [
    ("ccsgd", dict(momentum=0.9)),
    ("nag", dict(momentum=0.9)),
    ("nag", {}),
    ("dcasgd", dict(momentum=0.9)),
    ("dcasgd", {}),
    ("adagrad", {}),
    ("rmsprop", {}),
    ("rmsprop", dict(centered=True, clip_weights=0.3)),
    ("adadelta", {}),
    ("ftrl", {}),
]
IDS = ["%s%s" % (n, "-" + "-".join(sorted(k)) if k else "") for n, k in CASES]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cpu(x):
    return mt.nd.array(np.asarray(x), ctx=mt.cpu())


def _updaters(name, kw):
    idx2name = {0: "fc_weight", 1: "fc_bias"}    # the bias decays at 0
    opts = [m.optimizer.create(name, param_idx2name=idx2name,
                               **dict(COMMON, **kw)) for m in (mx, mt)]
    for opt in opts:
        opt.set_lr_mult({0: 0.5})
    return [m.optimizer.get_updater(o) for m, o in zip((mx, mt), opts)]


def _weights_and_grads(steps=3):
    rng = np.random.RandomState(3)
    weights = {0: rng.randn(4, 5).astype("f"), 1: rng.randn(5).astype("f")}
    grads = [{i: rng.randn(*w.shape).astype("f") for i, w in weights.items()}
             for _ in range(steps)]
    return weights, grads


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_classic_update_matches_the_jax_package(name, kw):
    weights, grads = _weights_and_grads()
    jup, tup = _updaters(name, kw)
    jw = {i: mx.nd.array(w) for i, w in weights.items()}
    tw = {i: _cpu(w) for i, w in weights.items()}
    for step in grads:
        for i, g in step.items():
            jup(i, mx.nd.array(g), jw[i])
            tup(i, _cpu(g), tw[i])
    for i in weights:
        assert _rel(tw[i].asnumpy(), jw[i].asnumpy()) < REL_TOL, i
        assert not np.array_equal(tw[i].asnumpy(), weights[i])
    # the updater's states round-trip: a restored one takes the same step
    restored = mt.optimizer.get_updater(mt.optimizer.create(
        name, param_idx2name={0: "fc_weight", 1: "fc_bias"},
        **dict(COMMON, **kw)))
    restored.optimizer.set_lr_mult({0: 0.5})
    restored.set_states(tup.get_states())
    restored.optimizer._index_update_count = dict(
        tup.optimizer._index_update_count)
    restored.optimizer.num_update = tup.optimizer.num_update
    w2 = {i: w.copy() for i, w in tw.items()}
    for i, g in grads[0].items():
        tup(i, _cpu(g), tw[i])
        restored(i, _cpu(g), w2[i])
        np.testing.assert_array_equal(w2[i].asnumpy(), tw[i].asnumpy())


def _mlp(m):
    data = m.sym.Variable("data")
    w = m.sym.Variable("fc1_weight", lr_mult=0.5)
    h = m.sym.FullyConnected(data, weight=w, num_hidden=16, name="fc1")
    h = m.sym.Activation(h, act_type="relu")
    h = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(h, name="softmax")


def _batches(n=3, batch=8, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 10).astype("f"),
             rng.randint(0, 4, batch).astype("f")) for _ in range(n)]


def _init(seed=2):
    shapes, _, _ = _mlp(mt).infer_shape(data=(8, 10))
    rng = np.random.RandomState(seed)
    return {n: rng.normal(0, 0.3, s).astype("f")
            for n, s in zip(_mlp(mt).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _module_steps(monkeypatch, policy, name, kw, batches, init):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", policy)
    with mt.cpu():
        mod = Module(_mlp(mt))
        mod.bind(data_shapes=[("data", (8, 10))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={k: mt.nd.array(v)
                                    for k, v in init.items()})
        mod.init_optimizer(optimizer=name,
                           optimizer_params=dict(COMMON, **kw))
        for x, y in batches:
            mod.forward(mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)]),
                        is_train=True)
            mod.backward()
            mod.update()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fused_rule_matches_the_classic_path(monkeypatch, name, kw):
    batches, init = _batches(), _init()
    fused, got = _module_steps(monkeypatch, "always", name, kw, batches,
                               init)
    classic, want = _module_steps(monkeypatch, "never", name, kw, batches,
                                  init)
    assert fused._trainer is not None and classic._trainer is None
    for k, w in want.items():
        assert _rel(got[k], w) < REL_TOL, k
        assert not np.array_equal(w, init[k]), k


def test_nag_runs_its_own_rule_on_the_classic_path():
    """NAG's classic step is Nesterov's, not SGD's in-place momentum
    step that it would inherit: two steps against the formula in numpy
    (``mom = m * mom + g; w -= lr * (g + m * mom)``)."""
    w0 = np.array([1.0, -2.0, 0.5], "f")
    grads = [np.array([0.3, -0.1, 0.2], "f"), np.array([-0.4, 0.2, 0.1], "f")]
    lr, m = 0.1, 0.9
    results = {}
    for name in ("nag", "sgd"):
        opt = mt.optimizer.create(name, learning_rate=lr, momentum=m)
        up = mt.optimizer.get_updater(opt)
        w = _cpu(w0)
        for g in grads:
            up(0, _cpu(g), w)
        results[name] = w.asnumpy()
    w, mom = w0.astype(np.float64), np.zeros(3)
    for g in grads:
        mom = m * mom + g
        w = w - lr * (g + m * mom)
    np.testing.assert_allclose(results["nag"], w, rtol=1e-6)
    assert _rel(results["sgd"], w) > 1e-2


def test_dcasgd_snapshot_is_a_tensor_of_its_own(monkeypatch):
    """DCASGD's state holds the weight's snapshot in storage of its own,
    on both paths: after an update it is the weight before the update,
    and the weight has moved."""
    opt = mt.optimizer.DCASGD(learning_rate=0.1, momentum=0.9)
    w = _cpu([1.0, 2.0, 3.0])
    state = opt.create_state(0, w)
    assert state[1].data.data_ptr() != w.data.data_ptr()
    before = w.asnumpy().copy()
    opt.update(0, w, _cpu([0.5, -0.5, 1.0]), state)
    np.testing.assert_array_equal(state[1].asnumpy(), before)
    assert not np.array_equal(w.asnumpy(), before)

    batches, init = _batches(2), _init()
    mod, _ = _module_steps(monkeypatch, "always", "dcasgd", {}, batches[:1],
                           init)
    tr = mod._trainer
    params = {k: v.clone() for k, v in tr.params.items()}
    for k, (mom, snap) in tr.opt_state.items():
        assert mom is None
        assert snap.data_ptr() != tr.params[k].data_ptr()
    tr.step({"data": batches[1][0], "softmax_label": batches[1][1]})
    for k, (_, snap) in tr.opt_state.items():
        assert torch.equal(snap, params[k]), k
        assert not torch.equal(tr.params[k], params[k]), k


def _trainer(name, kw, init, batch):
    with mt.cpu():
        t = Trainer(_mlp(mt), mt.optimizer.create(name, **dict(COMMON, **kw)))
    t.bind({"data": batch[0].shape}, {"softmax_label": batch[1].shape})
    t.init_params(arg_params={k: torch.from_numpy(v)
                              for k, v in init.items()})
    return t


@pytest.mark.parametrize("name,kw", CASES + [("sgd", {})],
                         ids=IDS + ["sgd"])
def test_trainer_states_blob_round_trips_every_state_tree(name, kw):
    """Two fused steps, the states blob into a fresh Trainer, then one
    more step on both: bitwise the same parameters and state."""
    batches, init = _batches(3), _init()
    steps = [{"data": x, "softmax_label": y} for x, y in batches]
    a = _trainer(name, kw, init, batches[0])
    for b in steps[:2]:
        a.step(b)
    b = _trainer(name, kw, init, batches[0])
    b.set_params({k: mt.nd.NDArray(v) for k, v in a.params.items()})
    b.set_opt_states(a.get_opt_states())
    assert b.num_update == 2
    a.step(steps[2])
    b.step(steps[2])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for x, y in zip(_leaves(a.opt_state), _leaves(b.opt_state)):
        assert torch.equal(x, y)


def test_a_states_blob_of_another_tree_raises():
    batches, init = _batches(1), _init()
    blob = _trainer("rmsprop", dict(centered=True), init,
                    batches[0]).get_opt_states()
    with pytest.raises(mt.MXNetError, match="keeps"):
        _trainer("rmsprop", {}, init, batches[0]).set_opt_states(blob)
    blob = _trainer("dcasgd", {}, init, batches[0]).get_opt_states()
    with pytest.raises(mt.MXNetError, match="keeps"):
        _trainer("adadelta", {}, init, batches[0]).set_opt_states(blob)


def test_sgld_noise_moments_and_determinism_per_seed():
    """SGLD with a zero gradient moves a weight by ``sqrt(lr)`` standard
    normal noise from the device's generator: its moments, the same
    draws for the same seed, others for another (the JAX package's
    threefry draws are other numbers)."""
    def draw(seed, lr=0.04):
        mt.random.seed(seed)
        opt = mt.optimizer.SGLD(learning_rate=lr)
        w = _cpu(np.zeros(20000, "f"))
        opt.update(0, w, _cpu(np.zeros(20000, "f")), opt.create_state(0, w))
        return w.asnumpy()

    a, b, c = draw(5), draw(5), draw(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.mean()) < 4 * 0.2 / np.sqrt(a.size)
    assert abs(a.std() - 0.2) < 0.01
    # the drift is half an SGD step, as in the JAX package's rule
    opt = mt.optimizer.SGLD(learning_rate=0.04)
    w = _cpu(np.zeros(20000, "f"))
    opt.update(0, w, _cpu(np.ones(20000, "f")), None)
    assert abs(w.asnumpy().mean() + 0.02) < 4 * 0.2 / np.sqrt(20000)


def test_sgld_trains_on_the_classic_path(monkeypatch):
    batches, init = _batches(1), _init()
    mod, params = _module_steps(monkeypatch, "always", "sgld", {}, batches,
                                init)
    assert mod._trainer is None and mod._exec_group is not None
    assert all(np.isfinite(v).all() for v in params.values())


def test_create_builds_every_optimizer_and_set_lr_scale_is_gone():
    names = ["sgd", "ccsgd", "nag", "sgld", "dcasgd", "adam", "adagrad",
             "rmsprop", "adadelta", "ftrl", "test"]
    for name in names:
        opt = mt.optimizer.create(name)
        assert type(opt).__name__.lower() == name
        assert type(opt).__name__ == type(mx.optimizer.create(name)).__name__
    assert set(names) <= set(mt.optimizer.Optimizer.opt_registry)
    with pytest.raises(DeprecationWarning, match="set_lr_mult"):
        mt.optimizer.create("sgd").set_lr_scale({})
