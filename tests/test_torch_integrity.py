"""The port's silent-data-corruption defence (``mxnet_tpu_torch/
integrity.py``, the fused Trainer's ``integrity`` modes, the manifest's
record in ``resilience.py`` and ``fit``'s rollback) on the CPU, against
the JAX package's (``mxnet_tpu/integrity.py``, ``tests/test_integrity.py``).

The fingerprint math, the leaf paths and the manifest records are held
bitwise against the JAX package on the same numpy arrays (made from a
seed).  Each test of ``tests/test_integrity.py`` runs on the port: those
of one device here, the votes over 2 and 4 gloo ranks that
``tools/launch.py`` starts (``tests/torch_dist_workers.py``'s
``integrity2`` and ``integrity4`` suites, both started at once)."""
import json
import os
import pickle
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import integrity as jinteg
from mxnet_tpu.parallel.optim import state_shapes as jstate_shapes

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import elastic, faults, integrity, resilience
from mxnet_tpu_torch.integrity import IntegrityError
from mxnet_tpu_torch.parallel.optim import make_update_fn
from mxnet_tpu_torch.parallel.trainer import Trainer

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _trainer(batch=8, **kw):
    with mt.cpu():
        t = Trainer(workers.integ_mlp(mt.sym), mt.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / batch),
            **kw)
        t.bind(data_shapes={"data": (batch, 32)},
               label_shapes={"softmax_label": (batch,)})
        t.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                  workers.integ_params().items()})
    return t


def _feed(t, x, y):
    return t.step({"data": x, "softmax_label": y})


# ======================================================================
# fingerprint math, bitwise the JAX package's
_RNG = np.random.RandomState(3)
_LEAVES = {
    "f32": _RNG.randn(4, 33).astype("f"),
    "bf16": _RNG.randn(37).astype(ml_dtypes.bfloat16),
    "f16": _RNG.randn(7).astype(np.float16),
    "int32": np.arange(-4, 9, dtype=np.int32),
    "uint32": np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 12345], np.uint32),
    "scalar": np.float32(2.5),
    "neg_zero": np.float32([0.0, -0.0, np.nan]),
}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kind", sorted(_LEAVES))
def test_leaf_fingerprint_is_the_jax_one(kind):
    """The port's device and host fingerprints equal the JAX package's
    jitted one and its numpy one, for each dtype and a 0-d leaf."""
    a = _LEAVES[kind]
    want = int(np.asarray(jax.jit(jinteg.leaf_fingerprint)(jnp.asarray(a))))
    assert want == jinteg.host_leaf_fingerprint(a)
    assert int(integrity.leaf_fingerprint(_torch(a))) == want
    assert integrity.host_leaf_fingerprint(a) == want
    assert integrity.host_leaf_fingerprint(_torch(a)) == want


def test_chunked_fingerprint_of_a_long_leaf(monkeypatch):
    """A leaf longer than a chunk sums its chunks' weights from their
    offsets: the same value as the JAX package's one pass."""
    monkeypatch.setattr(integrity, "CHUNK", 1000)
    monkeypatch.setattr(integrity, "_WEIGHTS", {})
    a = np.random.RandomState(5).randn(2500).astype("f")
    assert int(integrity.leaf_fingerprint(torch.from_numpy(a))) \
        == jinteg.host_leaf_fingerprint(a)


def test_host_fingerprint_bit_sensitivity_and_permutation():
    x = np.arange(64, dtype=np.float32)
    fp = integrity.host_leaf_fingerprint(x)
    y = x.copy()
    y.view(np.uint32)[17] ^= np.uint32(1 << 12)
    assert integrity.host_leaf_fingerprint(y) != fp
    assert integrity.host_leaf_fingerprint(x[::-1].copy()) != fp
    assert integrity.host_leaf_fingerprint(np.float32([0.0])) != \
        integrity.host_leaf_fingerprint(np.float32([-0.0]))


def test_fold_salts_and_records_are_the_jax_ones():
    named = [("arg:%s" % k, v) for k, v in sorted(_LEAVES.items())]
    got = integrity.host_fingerprint(named)
    assert got == jinteg.host_fingerprint(named)
    lf = torch.tensor([got[1][p] for p, _ in named])
    salts = torch.tensor([integrity.path_salt(p) for p, _ in named])
    assert int(integrity.fold_fingerprints(lf, salts)) == got[0]
    assert all(integrity.path_salt(p) == jinteg.path_salt(p)
               for p, _ in named)
    assert integrity.manifest_record(*got) == jinteg.manifest_record(*got)


# ======================================================================
# leaf paths: every optimizer the fused Trainer takes
_OPTIMIZERS = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("ccsgd", {}),
               ("nag", {"momentum": 0.9}), ("dcasgd", {}),
               ("dcasgd", {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
               ("rmsprop", {}), ("rmsprop", {"centered": True}),
               ("adadelta", {}), ("ftrl", {}), ("test", {})]


@pytest.mark.parametrize("name,kw", _OPTIMIZERS,
                         ids=["%s%s" % (n, "-" + "-".join(k) if k else "")
                              for n, k in _OPTIMIZERS])
def test_named_state_leaves_paths_are_the_jax_ones(name, kw):
    """``opt:NAME`` + ``jax.tree_util.keystr`` of each leaf of the
    optimizer's state, letter for letter, and the fused Trainer's
    check walks the same paths."""
    shapes = {"fc1_weight": (16, 32), "fc1_bias": (16,)}
    names = sorted(shapes)
    jstate = jstate_shapes(mx.optimizer.create(name, **kw), names, shapes)
    want = [p for p, _ in jinteg.named_state_leaves(
        {n: 0 for n in names}, {"bn_moving_mean": 0}, jstate)]
    init_fn, _ = make_update_fn(mt.optimizer.create(name, **kw), names)
    pstate = init_fn({n: torch.zeros(s) for n, s in shapes.items()})
    got = [p for p, _ in integrity.named_state_leaves(
        {n: 0 for n in names}, {"bn_moving_mean": 0}, pstate)]
    assert got == want
    with mt.cpu():
        t = Trainer(workers.integ_mlp(mt.sym),
                    mt.optimizer.create(name, **kw), integrity="fp")
        t.bind(data_shapes={"data": (8, 32)},
               label_shapes={"softmax_label": (8,)})
        t.init_params()
    jt = jstate_shapes(mx.optimizer.create(name, **kw), t.param_names,
                       t._arg_shapes)
    assert t._integ_paths == [p for p, _ in jinteg.named_state_leaves(
        {n: 0 for n in t.param_names}, {}, jt)]


# ======================================================================
# the vote's helpers and the fault grammar
_VOTES = [
    (np.array([[1, 2], [1, 2]]), [0, 1]),
    (np.array([[1, 2], [1, 3]]), [0, 1]),
    (np.array([[1, 2], [1, 3]]), [0]),
    (np.array([[1, 2], [1, 2], [1, 5], [1, 2]]), [0, 1]),
    (np.array([[1, 2], [1, 3], [1, 5], [1, 2]]), [0, 1]),
    (np.array([[7, 2], [1, 2], [1, 2]]), [0, 1]),
    (np.array([[1, 9], [2, 9]]), []),
    (np.array([[4, 4]]), [0, 1]),
]


@pytest.mark.parametrize("matrix,cols", _VOTES)
def test_blame_minority_is_the_jax_one(matrix, cols):
    assert integrity.blame_minority(matrix.astype(np.uint32), cols) == \
        jinteg.blame_minority(matrix.astype(np.uint32), cols)


@pytest.mark.parametrize("pattern", [
    "opt/fc1_weight[0]", "fc1_weight[1]", "arg/fc1_weight",
    "opt/fc1_weight[?]", "fc1_weight[2]", "*", "fc?_bias", "aux/*",
    "nosuch*"])
def test_match_leaf_is_the_jax_one(pattern):
    paths = ["arg:fc1_bias", "arg:fc1_weight", "aux:bn_moving_var",
             "opt:fc1_weight[0]", "opt:fc1_weight[1]"]
    assert integrity.match_leaf(pattern, paths) == \
        jinteg.match_leaf(pattern, paths)


@pytest.mark.parametrize("spec,match", [
    ("nan_grad@setp=3", "setp"), ("bitflip@step=1:lead=fc1*", "lead"),
    ("bitflip@step=1:rank=0:leaf=arg:fc1_weight", "leaf=arg/fc1_weight"),
    ("host_dead@step=1:bit=3", "payload key")])
def test_fault_grammar_errors(spec, match):
    with pytest.raises(mt.MXNetError, match=match.replace("*", r"\*")):
        faults.configure(spec)


def test_bitflip_payload_keys_carried_not_matched():
    faults.configure("bitflip@step=2:rank=0:leaf=fc?_weight:bit=5")
    assert faults.hit_params("bitflip", step=1, rank=0) is None
    assert faults.hit_params("bitflip", step=2, rank=0) == \
        {"leaf": "fc?_weight", "bit": 5}
    assert faults.hit_params("bitflip", step=3, rank=0) is None


@pytest.mark.parametrize("bit", [0, 12, 31])
def test_bitflip_flips_one_bit_in_place(bit):
    x = torch.arange(6, dtype=torch.float32)
    before = x.clone()
    same = integrity.bitflip(x, 1, bit=bit, my_rank=0)
    assert same is x and torch.equal(x, before)    # not this rank's copy
    integrity.bitflip(x, 1, bit=bit, my_rank=1)
    diff = (x.view(torch.int32) ^ before.view(torch.int32)).tolist()
    assert diff[0] in (1 << bit, (1 << bit) - (1 << 32)) and \
        not any(diff[1:])
    with pytest.raises(mt.MXNetError):
        integrity.bitflip(torch.zeros(2, dtype=torch.int32), 0)


# ======================================================================
# one device
def test_fingerprint_determinism_two_runs():
    recs = []
    for _ in range(2):
        t = _trainer(integrity="fp", integrity_period=2)
        for x, y in workers.integ_batches(4):
            _feed(t, x, y)
        recs.append(t.state_fingerprint())
    assert recs[0] == recs[1] and recs[0]["algo"] == jinteg.ALGO
    assert any(p.startswith("opt:") for p in recs[0]["leaves"])


def test_stepped_state_fingerprint_is_the_jax_host_one():
    """The port's device fingerprint of a stepped state equals the JAX
    package's ``host_fingerprint`` of the same arrays, leaf for leaf."""
    t = _trainer(integrity="fp", integrity_period=1)
    for x, y in workers.integ_batches(3):
        _feed(t, x, y)
    rec = t.state_fingerprint()
    named = [(p, v.numpy()) for p, v in t._named_state()]
    g, leaves = jinteg.host_fingerprint(named)
    assert rec == jinteg.manifest_record(g, leaves, mode="fp")
    # the in-step check's carry holds the same per-leaf values as the
    # state the next update reads
    _feed(t, *workers.integ_batches(4)[3])
    assert t._integ["leaf"][0].tolist() == [leaves[p] for p, _ in named]


@pytest.mark.parametrize("period", [1, 2, 3])
def test_fp_mode_is_bit_identical_to_off(period):
    toff = _trainer()
    tfp = _trainer(integrity="fp", integrity_period=period)
    for x, y in workers.integ_batches(5):
        _feed(toff, x, y)
        _feed(tfp, x, y)
    for n, v in toff.params.items():
        assert torch.equal(v, tfp.params[n]), n


def test_audit_fallback_single_device():
    t = _trainer(integrity="audit", integrity_period=3)
    assert t._integ_mode == "audit"
    faults.configure("bitflip@step=3:rank=0:leaf=fc2_weight:bit=5")
    with pytest.raises(IntegrityError) as err:
        for x, y in workers.integ_batches(6):
            _feed(t, x, y)
    assert err.value.record["mode"] == "audit"
    assert err.value.record["step"] == 3
    assert faults.fired("bitflip") == 1
    t2 = _trainer(integrity="audit", integrity_period=2)
    for x, y in workers.integ_batches(6):
        _feed(t2, x, y)
    assert t2.integrity_divergences == 0


def test_audit_keeps_the_live_result_and_replays_dropout():
    """The audit's replay restores what the step read (the Dropout
    generator's state too): a clean audited run with a Dropout is
    bitwise one without the audit."""
    def net(sym):
        d = sym.Variable("data")
        n = sym.FullyConnected(d, name="fc1", num_hidden=16)
        n = sym.Dropout(n, p=0.3, name="drop")
        n = sym.FullyConnected(n, name="fc2", num_hidden=4)
        return sym.SoftmaxOutput(n, name="softmax")

    runs = []
    for mode in ("off", "audit"):
        mt.random.seed(3)
        with mt.cpu():
            t = Trainer(net(mt.sym), mt.optimizer.Adam(), integrity=mode,
                        integrity_period=1)
            t.bind(data_shapes={"data": (8, 32)},
                   label_shapes={"softmax_label": (8,)})
            t.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                      workers.integ_params().items()})
        for x, y in workers.integ_batches(4):
            _feed(t, x, y)
        assert t.integrity_divergences == 0
        runs.append(t)
    for n, v in runs[0].params.items():
        assert torch.equal(v, runs[1].params[n]), n


def test_vote_falls_back_to_audit_without_data_mesh():
    assert _trainer(integrity="vote", integrity_period=2)._integ_mode \
        == "audit"


def test_bitflip_unmatched_leaf_glob_is_loud():
    t = _trainer(integrity="fp", integrity_period=100)
    faults.configure("bitflip@step=1:rank=0:leaf=nosuch*")
    with pytest.raises(mt.MXNetError, match=r"nosuch\*"):
        _feed(t, *workers.integ_batches(1)[0])


def test_nan_grad_fires_once_into_the_sentinel():
    t = _trainer(sentinel="skip")
    faults.configure("nan_grad@step=2")
    for x, y in workers.integ_batches(4):
        _feed(t, x, y)
    assert faults.fired("nan_grad") == 1 and t.sentinel_skips == 1


@pytest.mark.parametrize("option", [
    dict(integrity="paranoid"), dict(integrity="fp", integrity_period=0),
    dict(integrity_period="x")])
def test_bad_integrity_options_raise(option):
    with pytest.raises(mt.MXNetError):
        _trainer(**option)


# ======================================================================
# the manifest's record
def _fit_module(num_epoch, prefix=None, **kw):
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = "always"
    try:
        mt.random.seed(0)
        rng = np.random.RandomState(0)
        with mt.cpu():
            it = mt.io.NDArrayIter(rng.randn(40, 32).astype("f"),
                                   rng.randint(0, 4, 40).astype("f"),
                                   batch_size=8, shuffle=False)
            mod = mt.mod.Module(workers.integ_mlp(mt.sym))
            mod.fit(it, num_epoch=num_epoch,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9,
                                      "rescale_grad": 1.0 / 8},
                    initializer=mt.init.Xavier(), checkpoint=prefix, **kw)
    finally:
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    return mod


def _patch_with_valid_crc(mgr, ck, path, patch):
    with open(path, "rb") as f:
        blob = patch(f.read())
    with open(path, "wb") as f:
        f.write(blob)
    mpath = mgr._manifest_path(ck.epoch)
    with open(mpath) as f:
        man = json.load(f)
    man["files"][os.path.basename(path)] = {
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF, "size": len(blob)}
    with open(mpath, "w") as f:
        json.dump(man, f)


def _flip_middle_byte(blob):
    blob = bytearray(blob)
    blob[len(blob) // 2] ^= 0x10
    return bytes(blob)


def test_manifest_record_crosses_packages(tmp_path):
    """The port's record verifies under the JAX package's
    ``verify_manifest_record`` and ``CheckpointManager``; a record the JAX
    package makes from the same arrays equals it leaf for leaf."""
    prefix = str(tmp_path / "ck")
    _fit_module(2, prefix)
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest()
    rec = ck.manifest["integrity"]
    assert rec["algo"] == jinteg.ALGO
    assert any(p.startswith("opt:") for p in rec["leaves"])
    assert mgr.verify_fingerprint(ck)
    assert mgr.latest_verified().epoch == ck.epoch
    _, arg, aux = ck.load_params()
    with open(ck.states_path, "rb") as f:
        state = pickle.loads(f.read())[1]
    named = jinteg.named_state_leaves(
        {k: v.asnumpy() for k, v in arg.items()},
        {k: v.asnumpy() for k, v in aux.items()},
        {k: jax.tree_util.tree_map(lambda t: t.numpy(), v)
         for k, v in state.items()})
    assert jinteg.verify_manifest_record(rec, named)
    want = jinteg.manifest_record(*jinteg.host_fingerprint(named))
    assert want["leaves"] == rec["leaves"] and \
        want["global"] == rec["global"]
    assert mx.resilience.CheckpointManager(prefix).latest_verified().epoch \
        == ck.epoch


def test_jax_written_record_checks_arg_and_aux_leaves(tmp_path, caplog):
    """A manifest record the JAX package wrote: its ``arg:`` and ``aux:``
    leaves are re-hashed here and a changed one fails; its ``opt:``
    leaves, whose states file does not load in the port, are logged by
    name."""
    from mxnet_tpu import faults as jfaults
    jfaults.clear()
    prefix = str(tmp_path / "jax")
    rng = np.random.RandomState(0)
    it = mx.io.NDArrayIter(rng.randn(40, 32).astype("f"),
                           rng.randint(0, 4, 40).astype("f"),
                           batch_size=8, shuffle=False)
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = "always"
    try:
        mx.random.seed(0)
        jmod = mx.mod.Module(workers.integ_mlp(mx.sym), context=mx.cpu())
        jmod.fit(it, num_epoch=1, optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9,
            "rescale_grad": 1.0 / 8}, checkpoint=prefix)
    finally:
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest()
    rec = ck.manifest["integrity"]
    opt = sorted(p for p in rec["leaves"] if p.startswith("opt:"))
    assert opt and rec["algo"] == integrity.ALGO
    with caplog.at_level("WARNING"):
        assert mgr.verify_fingerprint(ck)
    assert all(p in caplog.text for p in opt)
    assert mgr.latest_verified().epoch == 1
    _patch_with_valid_crc(mgr, ck, ck.params_path, _flip_middle_byte)
    assert mgr.verify(1) is not None
    assert not mgr.verify_fingerprint(mgr.verify(1))
    assert mgr.latest_verified() is None


def test_manifest_verify_rejects_byte_patch_with_valid_crc(tmp_path):
    prefix = str(tmp_path / "ck")
    _fit_module(3, prefix)
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest()
    assert ck.epoch == 3
    _patch_with_valid_crc(mgr, ck, ck.params_path, _flip_middle_byte)
    assert mgr.verify(3) is not None and mgr.latest().epoch == 3
    assert not mgr.verify_fingerprint(mgr.verify(3))
    assert mgr.latest_verified().epoch == 2


def test_states_blob_patch_fails_fingerprint(tmp_path):
    prefix = str(tmp_path / "ck")
    _fit_module(2, prefix)
    mgr = resilience.CheckpointManager(prefix)
    ck = mgr.latest()

    def patch(blob):
        loaded = list(pickle.loads(blob))
        state = loaded[1]
        leaf = [v for v in integrity.named_state_leaves(
            opt_state=state)][0][1]
        leaf.view(-1)[0] += 1.0
        return pickle.dumps(tuple(loaded))

    _patch_with_valid_crc(mgr, ck, ck.states_path, patch)
    assert mgr.verify(ck.epoch) is not None
    assert not mgr.verify_fingerprint(mgr.verify(ck.epoch))
    assert mgr.latest_verified().epoch == ck.epoch - 1


def test_retention_never_deletes_newest_verified(tmp_path):
    prefix = str(tmp_path / "keep")
    mod = _fit_module(1)
    mgr = resilience.CheckpointManager(prefix, keep=10)
    mgr.save(mod, 1)
    real = mod.state_fingerprint

    def corrupt_fingerprint():
        rec = real()
        rec["global"] = (rec["global"] + 1) & 0xFFFFFFFF
        return rec

    mod.state_fingerprint = corrupt_fingerprint
    for epoch in (2, 3, 4):
        mgr.save(mod, epoch)
    mod.state_fingerprint = real
    mgr.keep = 2
    mgr._prune()
    names = sorted(os.listdir(tmp_path))
    assert any("-0001.params" in n for n in names), names
    assert not any("-0002." in n for n in names), names
    assert any("-0004.params" in n for n in names), names
    assert mgr.latest().epoch == 4
    assert mgr.latest_verified().epoch == 1


def test_fit_audit_rolls_back_to_verified_and_ends_bitwise(tmp_path,
                                                           monkeypatch):
    """One device: the audit detects the flip at its step, fit rolls
    back to the newest verified checkpoint, and the run ends bitwise
    equal to one without the fault."""
    monkeypatch.setenv("MXTPU_INTEGRITY_MODE", "audit")
    monkeypatch.setenv("MXTPU_INTEGRITY_PERIOD", "1")
    clean = _fit_module(3, str(tmp_path / "clean"))
    before = mt.obs.snapshot()["counters"]
    faults.configure("bitflip@step=8:rank=0:leaf=fc1_weight")
    inj = _fit_module(3, str(tmp_path / "inj"))
    after = mt.obs.snapshot()["counters"]
    assert inj._trainer.integrity_divergences == 1
    for name in ("integrity.divergences", "integrity.rollbacks"):
        assert after[name] == before.get(name, 0) + 1, name
    a, b = clean.get_params()[0], inj.get_params()[0]
    assert all(np.array_equal(a[k].asnumpy(), b[k].asnumpy()) for k in a)


# ======================================================================
# quarantine: the blame feeds the membership shrink
def test_quarantine_publishes_membership_without_rank(tmp_path):
    c0 = elastic.ElasticCoordinator(rank=0, num_workers=2,
                                    directory=str(tmp_path), hb_timeout=30,
                                    join_grace=30, check_interval=0.0)
    try:
        mem = c0.quarantine(1)
        assert mem.world == [0] and mem.dead == [1]
        assert c0.quarantine(1).epoch == mem.epoch
        with pytest.raises(mt.MXNetError):
            c0.quarantine(0)
    finally:
        c0.close()


def test_quarantine_folds_lapsed_peers_into_publish(tmp_path):
    import time
    from mxnet_tpu_torch import health
    health._reset_seq_cache()
    c0 = elastic.ElasticCoordinator(rank=0, num_workers=3,
                                    directory=str(tmp_path), hb_timeout=0.3,
                                    join_grace=0.0, check_interval=0.0)
    try:
        h2 = health.Heartbeat(2, directory=str(tmp_path), interval=999)
        h2.stop()
        time.sleep(0.4)
        h1 = health.Heartbeat(1, directory=str(tmp_path), interval=999)
        h1.stop()
        mem = c0.quarantine(1)
        assert mem.world == [0] and mem.dead == [1, 2]
    finally:
        c0.close()


# ======================================================================
# the vote over 2 and 4 gloo ranks (tools/launch.py)
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("MXTPU_MODULE_FUSED", "MXTPU_FAULTS", "MXTPU_INTEGRITY_MODE",
              "MXTPU_INTEGRITY_PERIOD"):
        env.pop(k, None)
    outs, procs = {}, []
    for n in (2, 4):
        outs[n] = tmp_path_factory.mktemp("integrity%d" % n)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "launch.py"), "-n",
             str(n), "--launcher", "local", "--", sys.executable,
             str(ROOT / "tests" / "torch_dist_workers.py"),
             "integrity%d" % n, str(outs[n])],
            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
    for p in procs:
        assert p.wait(timeout=240) == 0
    return outs


def _ranks(out, case, n):
    return [json.load(open(out / ("%s-rank%d.json" % (case, r))))
            for r in range(n)]


def test_bitflip_vote_detects_and_blame_resolves_via_replay(ranks):
    """2 ranks: a 1-vs-1 split raises with blame undetermined; the
    rollback replay blames rank 1, and the replayed run ends bitwise
    equal to one without the fault, on both ranks."""
    for r in _ranks(ranks[2], "vote-replay", 2):
        assert r["mode"] == "vote"
        rec = r["record"]
        assert rec["step"] == 8 and rec["mode"] == "vote"
        assert rec["leaves"] == ["arg:fc1_weight"]
        assert rec["blamed"] is None and r["divergences"] == 1
        assert r["replay_record"] is None and r["blamed"] == [[1]]
        assert r["bitwise"]


def test_two_replica_blame_indeterminate_when_not_adjacent(ranks):
    for r in _ranks(ranks[2], "vote-not-adjacent", 2):
        assert r["record"]["step"] == 8 and r["record"]["blamed"] is None
        assert r["blamed"] == [] and r["pending"] is None and r["bitwise"]


def test_vote_rows_are_the_ranks_fingerprints(ranks):
    """The record's rows: one a rank, agreeing on every leaf but the
    flipped one."""
    rec = _ranks(ranks[2], "vote-replay", 2)[0]["record"]
    rows = np.array(rec["fps"])
    assert rows.shape == (2, 8)
    assert (rows[0] != rows[1]).tolist() == [
        p == "arg:fc1_weight" for p in
        ["arg:fc1_bias", "arg:fc1_weight", "arg:fc2_bias", "arg:fc2_weight",
         "opt:fc1_bias", "opt:fc1_weight", "opt:fc2_bias",
         "opt:fc2_weight"]]


def test_bitflip_vote_majority_blames_at_detection(ranks):
    for r in _ranks(ranks[4], "vote-majority", 4):
        rec = r["record"]
        assert rec["mode"] == "vote" and rec["world"] == 4
        assert rec["blamed"] == [2] and rec["leaves"] == ["arg:fc2_weight"]
        assert r["blamed"] == [[2]]


def test_zero1_shard_checksums_and_layout_invariance(ranks):
    """ZeRO-1: the shards sit out the vote (no false alarm), and the
    record's fingerprints are of whole leaves, equal to the JAX
    package's host fingerprint of the gathered arrays."""
    for rank, r in enumerate(_ranks(ranks[2], "zero1", 2)):
        assert r["divergences"] == 0
        assert all(m for p, m in r["rep"].items() if p.startswith("arg:"))
        assert not any(m for p, m in r["rep"].items()
                       if p.startswith("opt:"))
        named = sorted(np.load(ranks[2] / ("zero1-state-rank%d.npz"
                                           % rank)).items())
        g, leaves = jinteg.host_fingerprint(named)
        assert r["record"]["global"] == g and r["record"]["leaves"] == leaves


def test_zero1_bitflip_on_replicated_leaf_detected(ranks):
    for r in _ranks(ranks[2], "zero1-flip", 2):
        assert r["record"]["leaves"] == ["arg:fc1_weight"]
        assert r["record"]["step"] == 8


def test_bitflip_targets_opt_leaf_via_namespace_alias(ranks):
    for r in _ranks(ranks[2], "opt-alias", 2):
        assert "opt:fc1_weight" in r["record"]["leaves"]


def test_fit_detect_rollback_restep_bit_identical(ranks):
    for r in _ranks(ranks[2], "fit-rollback", 2):
        assert r["divergences"] == 1 and r["blamed"] == [[1]]
        assert r["bitwise"]


def test_fit_divergence_cap_and_missing_checkpoint_are_loud(ranks):
    for r in _ranks(ranks[2], "fit-cases", 2):
        assert "consecutive divergences" in r["errors"]["cap"]
        assert "no checkpoint line" in r["errors"]["no-ckpt"]


def test_fit_blame_quarantines_outvoted_rank(ranks):
    for r in _ranks(ranks[2], "fit-cases", 2):
        assert r["quarantined"] == [1]


def test_save_refuses_fingerprint_on_divergent_state(ranks):
    for r in _ranks(ranks[2], "fit-cases", 2):
        assert r["refuse"] == {"first_verified": 1, "raised": True,
                               "latest": 2, "refused": True,
                               "verifies": False, "latest_verified": 1}
