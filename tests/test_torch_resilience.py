"""The port's crash-consistent checkpoints and auto-resume
(``mxnet_tpu_torch/resilience.py``, ``model.py``, ``Module.fit``'s
``checkpoint``/``resume``) on the CPU, against the JAX package's
(``tests/test_resilience.py``).

The inputs come from a numpy seed.  A resumed ``fit`` must reproduce the
uninterrupted run bit for bit, on the classic path and on the fused one,
with a Dropout in the graph; a checkpoint written by either package
verifies and loads in the other; the kill-and-resume runs in a
subprocess, so ``crash@ckpt_write``'s ``os._exit(137)`` is as abrupt as
a SIGKILL."""
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import resilience as jresilience

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides, the same rule in another order of sums
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _mlp(pkg, dropout=False):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = pkg.sym.Activation(net, name="relu1", act_type="relu")
    if dropout:
        net = pkg.sym.Dropout(net, p=0.3, name="drop")
    net = pkg.sym.FullyConnected(net, name="fc2", num_hidden=4)
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(160, 32).astype("f"),
            rng.randint(0, 4, 160).astype("f"))


def _train_iter(seed=0):
    x, y = _data(seed)
    with mt.cpu():
        return mt.io.NDArrayIter(x, y, batch_size=32, shuffle=False)


_OPT = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / 32}


def _fit_module(train, num_epoch, prefix=None, resume=False, fused="always",
                dropout=False, optimizer="sgd", **kw):
    """The port's ``fit`` of the MLP (SGD with momentum, or Adam) on the
    path ``fused`` names (``MXTPU_MODULE_FUSED``)."""
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = fused
    params = _OPT if optimizer == "sgd" else {"learning_rate": 0.01,
                                               "rescale_grad": 1.0 / 32}
    try:
        mt.random.seed(0)
        with mt.cpu():
            mod = mt.mod.Module(_mlp(mt, dropout))
            mod.fit(train, num_epoch=num_epoch, optimizer=optimizer,
                    optimizer_params=params, initializer=mt.init.Xavier(),
                    checkpoint=prefix, resume=resume, **kw)
    finally:
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    assert (mod._trainer is not None) == (fused == "always")
    return mod


def _params(mod):
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


# ======================================================================
# retry
def test_transient_io_error_is_retried():
    faults.configure("io_error@batch=2:count=2")
    _fit_module(_train_iter(), num_epoch=1)
    assert faults.fired("io_error") == 2         # failed twice, recovered


def test_persistent_io_error_propagates():
    faults.configure("io_error@batch=1:count=50")
    with pytest.raises(OSError, match="injected io_error"):
        _fit_module(_train_iter(), num_epoch=1)


class _FlakySource(mt.io.NDArrayIter):
    """Fails its ``fail_at``-th fetch (1-based) once with an ``OSError``,
    without advancing, as a read that timed out would."""

    def __init__(self, *args, fail_at, **kw):
        super().__init__(*args, **kw)
        self._fail_at = fail_at
        self.fetches = 0

    def next(self):
        self.fetches += 1
        if self.fetches == self._fail_at:
            raise OSError("transient read error")
        return super().next()


@pytest.mark.parametrize("fail_at", [1, 3])
def test_upload_worker_resumes_after_a_source_error(monkeypatch, fail_at):
    """On the fused path ``fit`` stages batches through
    ``DeviceUploadIter``, whose worker meets the source's error.  The
    retried fetch resumes the stream: every batch of every epoch trains,
    and the parameters equal a run whose source never failed."""
    monkeypatch.setenv("MXTPU_UPLOAD_OVERLAP", "1")
    x, y = _data()
    with mt.cpu():
        flaky = _FlakySource(x, y, batch_size=32, shuffle=False,
                             fail_at=fail_at)
    trained = []
    mod = _fit_module(flaky, num_epoch=2,
                      batch_end_callback=lambda p: trained.append(
                          (p.epoch, p.nbatch)))
    assert trained == [(e, b) for e in range(2) for b in range(5)]
    ref = _params(_fit_module(_train_iter(), num_epoch=2))
    for k, v in _params(mod).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


class _NextOnlySource:
    """A source with ``next``, ``reset`` and the descriptors but no
    ``__next__``, as a user's iterator may be."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_size = inner.batch_size

    provide_data = property(lambda self: self.inner.provide_data)
    provide_label = property(lambda self: self.inner.provide_label)

    def reset(self):
        self.inner.reset()

    def next(self):
        return self.inner.next()


def test_upload_worker_takes_a_source_with_only_next():
    up = mt.io.DeviceUploadIter(_NextOnlySource(_train_iter()),
                                device=mt.cpu())
    try:
        assert sum(1 for _ in up) == 5
    finally:
        up._shutdown_worker()


@pytest.mark.parametrize("fused", ["never", "always"])
def test_states_of_another_format_raise_naming_the_file(tmp_path, fused):
    """The port reads only the states format it writes: the fused
    trainer's 4-tuple, the classic path's tagged tuple."""
    mod = _fit_module(_train_iter(), num_epoch=1, fused=fused)
    good = str(tmp_path / "good.states")
    mod.save_optimizer_states(good)
    with open(good, "rb") as f:
        loaded = pickle.loads(f.read())
    # the fused blob without its last member; the classic blob's bare
    # updater states
    other = loaded[:3] if fused == "always" else loaded[1]
    bad = str(tmp_path / "bad.states")
    with open(bad, "wb") as f:
        f.write(other if isinstance(other, bytes) else pickle.dumps(other))
    with pytest.raises(mt.MXNetError, match="not the (fused trainer|port)"):
        mod.load_optimizer_states(bad)
    with pytest.raises(mt.MXNetError) as err:
        mod.load_optimizer_states(bad)
    assert bad in str(err.value)
    mod.load_optimizer_states(good)


def test_retry_io_backoff_bounds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert resilience.retry_io(flaky, attempts=3, delay=0.001) == "ok"
    assert len(calls) == 3
    with pytest.raises(OSError):
        resilience.retry_io(lambda: (_ for _ in ()).throw(OSError("x")),
                            attempts=2, delay=0.001)
    with pytest.raises(StopIteration):          # not a transient fault
        resilience.retry_io(lambda: next(iter(())), attempts=3, delay=0)


@pytest.mark.parametrize("jitter,seed", [(0.1, 7), (0.1, 11), (0, None)])
def test_retry_io_sleeps_as_the_jax_package(monkeypatch, jitter, seed):
    """The decorrelated backoff: for one seed, the port sleeps exactly the
    JAX package's sequence."""
    def fail():
        raise OSError("transient")

    seqs = []
    for mod in (jresilience, resilience):
        sleeps = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        with pytest.raises(OSError):
            mod.retry_io(fail, attempts=4, delay=0.05, backoff=2.0,
                         jitter=jitter,
                         rng=None if seed is None else random.Random(seed))
        seqs.append(sleeps)
    assert len(seqs[1]) == 3 and seqs[0] == seqs[1]
    if not jitter:
        assert seqs[1] == pytest.approx([0.05, 0.1, 0.2])


# ======================================================================
# the checkpoint manager
def test_checkpoint_manager_latest_skips_corrupt(tmp_path):
    prefix = str(tmp_path / "ck")
    _fit_module(_train_iter(), num_epoch=3, prefix=prefix)
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest()
    assert ck is not None and ck.epoch == 3
    assert ck.step == 15                     # 5 batches x 3 epochs
    with open(ck.params_path, "r+b") as f:   # a truncated newest save
        f.truncate(64)
    assert mgr.latest().epoch == 2
    os.remove(mgr._manifest_path(2))         # an uncommitted save
    assert mgr.latest().epoch == 1


def test_checkpoint_retention(tmp_path):
    prefix = str(tmp_path / "keep")
    mgr = resilience.CheckpointManager(prefix, keep=2)
    mod = _fit_module(_train_iter(), num_epoch=1)
    for epoch in (1, 2, 3, 4):
        mgr.save(mod, epoch)
    names = sorted(os.listdir(tmp_path))
    assert not any("-0001." in n or "-0002." in n for n in names), names
    assert "keep-0003.params" in names and "keep-0004.states" in names


@pytest.mark.parametrize("site,left", [
    ("crash@ckpt_write:save=2:soft", "-0002.params.tmp"),
    ("crash@manifest_write:epoch=2:soft", "-0002.manifest.json.tmp")])
def test_soft_crash_between_write_and_rename(tmp_path, site, left):
    """A crash between a file's write and its rename leaves the ``.tmp``
    and commits nothing of the save; the resume scan sweeps the ``.tmp``
    and settles on the previous checkpoint."""
    prefix = str(tmp_path / "soft")
    mod = _fit_module(_train_iter(), num_epoch=1, prefix=prefix)
    mgr = resilience.CheckpointManager(prefix)
    faults.configure(site)
    with pytest.raises(faults.InjectedCrash):
        mgr.save(mod, 2)
    faults.clear()
    assert os.path.exists(prefix + left)
    assert not os.path.exists(prefix + "-0002.manifest.json")
    ck = mgr.latest()
    assert ck is not None and ck.epoch == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_load_checkpoint_names_corrupt_file(tmp_path):
    prefix = str(tmp_path / "bad")
    _fit_module(_train_iter(), num_epoch=1, prefix=prefix)
    path = prefix + "-0001.params"
    for damage in (lambda f: f.truncate(40),
                   lambda f: f.write(b"\x00" * 64)):
        with open(path, "r+b") as f:
            damage(f)
        with pytest.raises(mt.MXNetError) as err:
            mt.model.load_checkpoint(prefix, 1)
        assert path in str(err.value)


def test_latest_rejects_torn_symbol_json(tmp_path):
    """The symbol JSON is in every manifest: tearing it invalidates every
    checkpoint under the prefix."""
    prefix = str(tmp_path / "sym")
    _fit_module(_train_iter(), num_epoch=2, prefix=prefix)
    mgr = resilience.CheckpointManager(prefix)
    assert mgr.latest().epoch == 2
    assert mgr.latest_verified().epoch == 2     # the record re-hashes
    with open(prefix + "-symbol.json", "r+") as f:
        f.truncate(10)
    assert mgr.latest() is None


def test_latest_verified_memoizes_on_disk_identity(tmp_path, monkeypatch):
    prefix = str(tmp_path / "vc")
    _fit_module(_train_iter(), num_epoch=2, prefix=prefix)
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest_verified()
    assert ck.epoch == 2
    calls = []
    real = resilience._crc32_file
    monkeypatch.setattr(resilience, "_crc32_file",
                        lambda p, *a: calls.append(p) or real(p, *a))
    assert mgr.latest_verified().epoch == 2
    assert calls == []                      # no byte re-hashed
    with open(ck.params_path, "r+b") as f:  # a same-size byte patch
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    assert mgr.latest_verified().epoch == 1


def test_async_write_and_elastic_name_their_slices(tmp_path):
    """``async_write`` still names its slice (item 9); ``fit(elastic=)``
    is taken (item 5): a coordinator of a world of one guards every
    step and the run ends bitwise equal to one without it."""
    mod = _fit_module(_train_iter(), num_epoch=1)
    arg, aux = mod.get_params()
    with pytest.raises(mt.MXNetError, match="item 9"):
        mt.model.save_checkpoint(str(tmp_path / "a"), 1, mod.symbol, arg,
                                 aux, async_write=True)
    coord = mt.elastic.ElasticCoordinator(rank=0, num_workers=1,
                                          directory=str(tmp_path / "e"))
    try:
        guarded = _fit_module(_train_iter(), num_epoch=1, elastic=coord)
    finally:
        coord.close()
    assert coord._guards == 5
    want, got = _params(mod), _params(guarded)
    assert all(np.array_equal(want[n], got[n]) for n in want)


# ======================================================================
# resume
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("fused", ["never", "always"])
def test_fit_resume_matches_uninterrupted(tmp_path, fused, optimizer):
    """Two epochs, then a resumed ``fit`` to four, against four at once:
    bitwise, with a Dropout whose generator state the states file
    carries (and, on the classic path, Adam's update counts)."""
    kw = dict(fused=fused, dropout=True, optimizer=optimizer)
    want = _params(_fit_module(_train_iter(), num_epoch=4,
                               prefix=str(tmp_path / "A"), **kw))
    prefix = str(tmp_path / "B")
    _fit_module(_train_iter(), num_epoch=2, prefix=prefix, **kw)
    mod = _fit_module(_train_iter(), num_epoch=4, prefix=prefix,
                      resume=True, **kw)
    got = _params(mod)
    for n in want:
        assert np.array_equal(want[n], got[n]), n
    manifest = json.load(open(prefix + "-0004.manifest.json"))
    assert manifest["rng"]["impl"] == resilience.RNG_IMPL
    # the fused path's record covers the optimizer state, the classic
    # path's the parameters (a host hash, as in the JAX package)
    record = manifest["integrity"]
    assert record["mode"] == ("off" if fused == "always" else "host")
    assert any(p.startswith("opt:") for p in record["leaves"]) \
        == (fused == "always")
    assert resilience.CheckpointManager(prefix).verify_fingerprint(
        resilience.CheckpointManager(prefix).verify(4))
    assert manifest["step"] == (20 if fused == "always" else None)


def test_fit_resume_without_checkpoints_starts_fresh(tmp_path):
    mod = _fit_module(_train_iter(), num_epoch=1,
                      prefix=str(tmp_path / "fresh"), resume=True)
    assert mod.binded and mod.params_initialized
    assert resilience.CheckpointManager(str(tmp_path / "fresh")) \
        .latest().epoch == 1


_E2E_SCRIPT = r"""
import os, sys
import numpy as np
import mxnet_tpu_torch as mt

prefix, num_epoch, resume = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
mt.random.seed(0)
rng = np.random.RandomState(0)
x = rng.randn(160, 32).astype("f")
y = rng.randint(0, 4, 160).astype("f")
with mt.cpu():
    train = mt.io.NDArrayIter(x, y, batch_size=32, shuffle=False)
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = mt.sym.Activation(net, name="relu1", act_type="relu")
    net = mt.sym.Dropout(net, p=0.3, name="drop")
    net = mt.sym.FullyConnected(net, name="fc2", num_hidden=4)
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net)
    mod.fit(train, num_epoch=num_epoch,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "rescale_grad": 1.0 / 32},
            initializer=mt.init.Xavier(), checkpoint=prefix, resume=resume)
arg, _ = mod.get_params()
np.savez(prefix + "-final.npz", **{k: v.asnumpy() for k, v in arg.items()})
print("COMPLETED")
"""


def _run_e2e(tmp_path, prefix, num_epoch, resume, fault=None):
    env = dict(os.environ, MXTPU_MODULE_FUSED="always",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("MXTPU_FAULTS", None)
    if fault:
        env["MXTPU_FAULTS"] = fault
    script = tmp_path / "e2e_train.py"
    script.write_text(_E2E_SCRIPT)
    return subprocess.run(
        [sys.executable, str(script), prefix, str(num_epoch),
         "1" if resume else "0"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)


def test_kill_and_resume_e2e(tmp_path):
    """A run killed inside its third save (exit 137, a ``.tmp`` left),
    then restarted with ``resume=True``, ends where the uninterrupted run
    (this process, the same script's calls) ends, bit for bit; the
    restart sweeps the ``.tmp``."""
    want = _params(_fit_module(_train_iter(), num_epoch=4, dropout=True))
    prefix = str(tmp_path / "killed")
    res = _run_e2e(tmp_path, prefix, 4, resume=False,
                   fault="crash@ckpt_write:save=3")
    assert res.returncode == 137, (res.returncode, res.stderr)
    assert "COMPLETED" not in res.stdout
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    res = _run_e2e(tmp_path, prefix, 4, resume=True)
    assert res.returncode == 0, res.stderr
    got = np.load(prefix + "-final.npz")
    for n in want:
        assert np.array_equal(want[n], got[n]), n
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


# ======================================================================
# across packages
def _jax_fit(prefix, fused, num_epoch=2, init=None):
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = fused
    try:
        x, y = _data()
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=32, shuffle=False),
                num_epoch=num_epoch, optimizer_params=_OPT,
                arg_params={k: mx.nd.array(v) for k, v in init.items()},
                checkpoint=prefix)
    finally:
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    return mod


def _init():
    rng = np.random.RandomState(5)
    return {"fc1_weight": rng.randn(16, 32).astype("f") * 0.1,
            "fc1_bias": np.zeros(16, "f"),
            "fc2_weight": rng.randn(4, 16).astype("f") * 0.1,
            "fc2_bias": np.zeros(4, "f")}


@pytest.mark.parametrize("fused", ["never", "always"])
def test_checkpoints_cross_packages(tmp_path, fused):
    """From the same initial weights both packages' ``fit(checkpoint=)``
    reach the same parameters (the JAX package's classic path's, which
    keeps the optimizer state as the port does on both); each one's manifest and params verify and
    load in the other.  The JAX package's integrity record verifies in
    the port on its ``arg:``/``aux:`` leaves (its ``opt:`` leaves are
    named as not checked), and its optimizer-state file raises naming
    the file; the port's record verifies in the JAX package."""
    init = _init()
    jprefix, pprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    jmod = _jax_fit(jprefix, fused, init=init)
    # the port keeps the optimizer state through fit's epoch-end refresh
    # on both paths, as the JAX package's classic path does (its fused
    # fit re-creates it; ROADMAP §C): the port's parameters are held
    # against that path's
    kept = jmod if fused == "never" else _jax_fit(
        str(tmp_path / "jax_classic"), "never", init=init)
    pmod = _fit_module(_train_iter(), num_epoch=2, prefix=pprefix,
                       fused=fused,
                       arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                   for k, v in init.items()})
    want = {k: v.asnumpy() for k, v in kept.get_params()[0].items()}
    got = _params(pmod)
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= REL_TOL * np.linalg.norm(w), k

    ck = resilience.CheckpointManager(jprefix).latest()
    assert ck is not None and ck.epoch == 2 and ck.states_path
    _, arg, _ = ck.load_params()
    for k, w in jmod.get_params()[0].items():
        assert np.array_equal(arg[k].asnumpy(), w.asnumpy()), k
    assert resilience.CheckpointManager(jprefix).verify_fingerprint(ck)
    with pytest.raises(mt.MXNetError) as err:
        _fit_module(_train_iter(), num_epoch=3, prefix=jprefix, resume=True,
                    fused=fused)
    assert ck.states_path in str(err.value)

    jck = jresilience.CheckpointManager(pprefix).latest()
    assert jck is not None and jck.epoch == 2
    assert jresilience.CheckpointManager(pprefix).latest_verified() \
        .epoch == 2
    _, jarg, _ = jck.load_params()
    for k, v in got.items():
        assert np.array_equal(jarg[k].asnumpy(), v), k
