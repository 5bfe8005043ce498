"""The port's elastic membership (``mxnet_tpu_torch/elastic.py``) on the
CPU, against the JAX package's (``mxnet_tpu/elastic.py``,
``tests/test_elastic.py``).

Each test of ``tests/test_elastic.py`` runs on the port: membership
epochs driven in one process with crafted heartbeat state (publish once
per epoch, a late rejoiner revoked, the step barrier, the ``hb_stall``
split brain, the ``host_dead`` grammar), and the launcher's end-to-end
drill (``slow``, as the JAX package's): 2 workers, one killed, the
survivor shrinks to 1, resumes, and ends bitwise equal to a
one-process replay from the same checkpoint.  Membership records cross
packages both ways."""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import elastic, faults, health
from mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    faults.clear()
    health._reset_seq_cache()
    monkeypatch.delenv("MXTPU_ELASTIC_DIR", raising=False)
    monkeypatch.delenv("MXTPU_HEARTBEAT_DIR", raising=False)
    yield
    faults.clear()


def _coord(tmp_path, rank, n=2, **kw):
    kw.setdefault("hb_timeout", 0.3)
    kw.setdefault("step_timeout", 0.6)
    kw.setdefault("check_interval", 0.0)
    kw.setdefault("join_grace", 0.0)
    kw.setdefault("barrier_attempts", 2)
    return elastic.ElasticCoordinator(rank=rank, num_workers=n,
                                      directory=str(tmp_path), **kw)


# ======================================================================
# the record crosses packages
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_membership_record_crosses_packages(tmp_path, writer):
    """A record either package commits reads back whole in the other,
    and the file is the same JSON."""
    w, r = (elastic, jelastic) if writer == "port" else (jelastic, elastic)
    w._write_membership(str(tmp_path), w.Membership(
        3, [0, 2], 4, wallclock=12.5, dead=[3, 1]))
    got = r.read_membership(str(tmp_path), 4)
    assert got.to_dict() == {"epoch": 3, "world": [0, 2], "num_workers": 4,
                             "wallclock": 12.5, "dead": [1, 3]}
    assert elastic.membership_path("d", "serve") == \
        jelastic.membership_path("d", "serve")
    assert (elastic.SHRINK_EXIT_CODE, elastic.COMM_PLAN_UNTRACED) == \
        (jelastic.SHRINK_EXIT_CODE, jelastic.COMM_PLAN_UNTRACED)
    # a missing record: the founding epoch in both
    assert r.read_membership(str(tmp_path / "none"), 2).to_dict() == \
        w.read_membership(str(tmp_path / "none"), 2).to_dict()


def test_port_shrink_is_observed_by_a_jax_coordinator(tmp_path):
    """The port's monitor publishes a shrink; a JAX package coordinator
    of the surviving world observes it as ElasticShrink."""
    c0 = _coord(tmp_path, 0, n=3)
    with pytest.raises(elastic.ElasticShrink):
        c0.guard(1)                  # ranks 1, 2 never stamped
    c0.close()
    j1 = jelastic.ElasticCoordinator(rank=1, num_workers=3,
                                     directory=str(tmp_path),
                                     hb_timeout=30, join_grace=30,
                                     check_interval=0.0)
    with pytest.raises(jelastic.ElasticRevoked):
        j1.guard(1)
    j1.close()


def test_comm_plan_digest_is_the_jax_one():
    from mxnet_tpu.analysis.comm_passes import plan_digest
    keys = ["psum:f32[16]:data", "all_gather:f32[4,2]:data"]
    assert elastic.plan_digest(keys) == plan_digest(keys)


# ======================================================================
# membership epochs
def test_monitor_shrinks_once_per_epoch(tmp_path):
    c0 = _coord(tmp_path, 0)
    with pytest.raises(elastic.ElasticShrink) as err:
        c0.guard(1)
    assert not isinstance(err.value, elastic.ElasticRevoked)
    mem = elastic.read_membership(str(tmp_path), 2)
    assert mem.epoch == 2 and mem.world == [0] and mem.dead == [1]
    assert mem.wallclock is not None
    c0.close()
    c0b = _coord(tmp_path, 0)
    c0b.guard(2)
    assert elastic.read_membership(str(tmp_path), 2).epoch == 2
    c0b.close()


def test_late_rejoiner_observes_revocation(tmp_path):
    c0 = _coord(tmp_path, 0)
    with pytest.raises(elastic.ElasticShrink):
        c0.guard(1)
    c0.close()
    before = elastic.read_membership(str(tmp_path), 2).to_dict()
    c1 = _coord(tmp_path, 1)
    with pytest.raises(elastic.ElasticRevoked):
        c1.guard(1)
    assert elastic.read_membership(str(tmp_path), 2).to_dict() == before
    c1.close()


def test_survivor_adopts_peer_published_epoch(tmp_path):
    c1 = _coord(tmp_path, 1, n=3)
    elastic._write_membership(str(tmp_path), elastic.Membership(
        2, [0, 1], 3, wallclock=time.time(), dead=[2]))
    with pytest.raises(elastic.ElasticShrink) as err:
        c1.guard(5)
    assert err.value.membership.epoch == 2
    assert err.value.membership.world == [0, 1]
    c1.close()


def test_join_grace_protects_slow_starters(tmp_path):
    c0 = _coord(tmp_path, 0, join_grace=60.0, step_timeout=0.3,
                barrier_attempts=1)
    with pytest.raises(MXNetError, match="wedged"):
        c0.guard(1)
    h1 = health.Heartbeat(1, directory=str(tmp_path), interval=999)
    h1.stop()
    time.sleep(0.4)
    with pytest.raises(elastic.ElasticShrink):
        c0.guard(2)
    c0.close()


def test_nonpublisher_waits_for_published_epoch(tmp_path):
    h0 = health.Heartbeat(0, directory=str(tmp_path), interval=0.05)
    h2 = health.Heartbeat(2, directory=str(tmp_path), interval=999)
    h2.stop()
    time.sleep(0.4)
    c1 = _coord(tmp_path, 1, n=3, step_timeout=5.0)
    published = elastic.Membership(2, [0, 1], 3, wallclock=time.time(),
                                   dead=[2])
    timer = threading.Timer(
        0.5, lambda: elastic._write_membership(str(tmp_path), published))
    timer.start()
    t0 = time.monotonic()
    with pytest.raises(elastic.ElasticShrink) as err:
        c1.guard(1)
    assert not isinstance(err.value, elastic.ElasticRevoked)
    assert err.value.membership.epoch == 2
    assert err.value.membership.world == [0, 1]
    assert 0.3 < time.monotonic() - t0 < 5.0
    timer.join()
    h0.stop()
    c1.close()


def test_new_incarnation_adopts_stale_shared_dir(tmp_path):
    elastic._write_membership(str(tmp_path), elastic.Membership(
        2, [0, 2, 3], 4, wallclock=time.time() - 60, dead=[1]))
    old = time.time() - 60
    for rank in range(4):
        hb = tmp_path / ("hb-%d" % rank)
        hb.write_text("%f 9" % old)
        os.utime(hb, (old, old))
        (tmp_path / ("step-%d" % rank)).write_text("2 40\n")
    c1 = _coord(tmp_path, 1, n=3, join_grace=60.0, step_timeout=0.4,
                barrier_attempts=1)
    mem = c1.membership()
    assert mem.epoch == 3 and mem.world == [0, 1, 2]
    c0 = _coord(tmp_path, 0, n=3, join_grace=60.0, step_timeout=0.4,
                barrier_attempts=1)
    on_disk = elastic.read_membership(str(tmp_path), 3)
    assert on_disk.epoch == 3 and on_disk.num_workers == 3
    with pytest.raises(MXNetError, match="wedged"):
        c0.guard(1)
    c0.close()
    c1.close()


# ======================================================================
# the step barrier
def test_barrier_synchronizes_live_ranks(tmp_path):
    c0 = _coord(tmp_path, 0, step_timeout=5.0, join_grace=60.0,
                hb_timeout=5.0)
    c1 = _coord(tmp_path, 1, step_timeout=5.0, join_grace=60.0,
                hb_timeout=5.0)
    errs = []

    def run(c):
        try:
            for step in (1, 2, 3):
                c.guard(step)
        except Exception as e:                  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in (c0, c1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    c0.close()
    c1.close()


def test_barrier_detects_death_during_wait(tmp_path):
    h1 = health.Heartbeat(1, directory=str(tmp_path), interval=0.05)
    c0 = _coord(tmp_path, 0, hb_timeout=0.3, step_timeout=30.0,
                check_interval=0.05, join_grace=60.0)
    with open(os.path.join(str(tmp_path), "step-1"), "w") as f:
        f.write("0\n")
    h1.stop()
    t0 = time.monotonic()
    with pytest.raises(elastic.ElasticShrink):
        c0.guard(1)
    assert time.monotonic() - t0 < 10.0
    c0.close()


def test_comm_plan_untraced_pair_logs_unverified(tmp_path, caplog):
    """The port publishes the untraced sentinel (it traces no comm plan
    yet): the first guard waits for every member's stamp and logs the
    pair as unverified instead of failing."""
    c0 = _coord(tmp_path, 0, step_timeout=5.0, join_grace=60.0,
                hb_timeout=5.0)
    c1 = _coord(tmp_path, 1, step_timeout=5.0, join_grace=60.0,
                hb_timeout=5.0)
    for c in (c0, c1):
        c.publish_comm_plan([], digest=elastic.COMM_PLAN_UNTRACED)
    errs = []
    threads = [threading.Thread(target=lambda c=c: errs.extend(
        [] if c.guard(1) else ["no membership"])) for c in (c0, c1)]
    with caplog.at_level("WARNING", logger="mxtpu.elastic"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not errs
    assert "UNVERIFIED" in caplog.text
    c0.close()
    c1.close()


# ======================================================================
# split brain: the heartbeat stalls, the process lives
def test_hb_stall_split_brain(tmp_path):
    faults.configure("hb_stall@beat=2:rank=1")
    h1 = health.Heartbeat(1, directory=str(tmp_path), interval=0.02)
    deadline = time.time() + 5.0
    while not h1.stalled and time.time() < deadline:
        time.sleep(0.02)
    assert h1.stalled and h1.active
    assert faults.fired("hb_stall") == 1
    time.sleep(0.4)
    c0 = _coord(tmp_path, 0)
    with pytest.raises(elastic.ElasticShrink) as err:
        c0.guard(1)
    assert err.value.dead == [1]
    c0.close()
    c1 = elastic.ElasticCoordinator(rank=1, num_workers=2,
                                    directory=str(tmp_path), heartbeat=h1,
                                    hb_timeout=0.3, check_interval=0.0)
    with pytest.raises(elastic.ElasticRevoked):
        c1.guard(1)
    h1.stop()


def test_shrink_and_revocation_counters(tmp_path):
    before = mt.obs.snapshot()["counters"]
    c0 = _coord(tmp_path, 0)
    with pytest.raises(elastic.ElasticShrink):
        c0.guard(1)
    c0.close()
    c1 = _coord(tmp_path, 1)
    with pytest.raises(elastic.ElasticRevoked):
        c1.guard(1)
    c1.close()
    after = mt.obs.snapshot()["counters"]
    for name in ("elastic.shrinks", "elastic.revocations"):
        assert after[name] == before.get(name, 0) + 1, name


# ======================================================================
# the fault grammar and sites
def test_host_dead_rank_matches_exactly():
    faults.configure("host_dead@step=3:rank=1")
    assert not faults.hit("host_dead", step=3, rank=0)
    assert not faults.hit("host_dead", step=3, rank=2)
    assert not faults.hit("host_dead", step=2, rank=1)
    assert faults.hit("host_dead", step=3, rank=1)
    assert not faults.hit("host_dead", step=4, rank=1)
    assert faults.fired("host_dead") == 1


_HOST_DEAD = """
import numpy as np, mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel.trainer import Trainer
d = mt.sym.Variable("data")
net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(d, num_hidden=3,
                                                 name="fc"), name="softmax")
with mt.cpu():
    t = Trainer(net, mt.optimizer.SGD())
    t.bind(data_shapes={"data": (4, 5)},
           label_shapes={"softmax_label": (4,)})
    t.init_params()
    for step in range(1, 5):
        print("step", step, flush=True)
        t.step({"data": np.ones((4, 5), "f"),
                "softmax_label": np.zeros(4, "f")})
"""


def test_host_dead_in_the_trainer_step_dies_before_the_step():
    """A run without a coordinator: the targeted rank dies as SIGKILL
    would, at the start of its step-3 update."""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               MXTPU_FAULTS="host_dead@step=3:rank=0")
    env.pop("MXTPU_COORDINATOR", None)
    res = subprocess.run([sys.executable, "-c", _HOST_DEAD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 137, res.stderr
    assert res.stdout.split() == ["step", "1", "step", "2", "step", "3"]


def test_fit_guards_every_batch(tmp_path):
    """``fit(elastic=)``: the guard before every step, with the update
    the step is about to take; a world of one passes straight through."""
    calls = []

    class Recorder(elastic.ElasticCoordinator):
        def guard(self, step=None):
            calls.append(step)
            return super().guard(step)

    coord = Recorder(rank=0, num_workers=1, directory=str(tmp_path))
    rng = np.random.RandomState(0)
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = "always"
    try:
        with mt.cpu():
            it = mt.io.NDArrayIter(rng.randn(24, 5).astype("f"),
                                   rng.randint(0, 3, 24).astype("f"),
                                   batch_size=8)
            net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
                mt.sym.Variable("data"), num_hidden=3, name="fc"),
                name="softmax")
            mod = mt.mod.Module(net)
            mod.fit(it, num_epoch=2, elastic=coord)
    finally:
        coord.close()
        if old is None:
            os.environ.pop("MXTPU_MODULE_FUSED", None)
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old
    assert calls == [1, 2, 3, 4, 5, 6]
    assert mod._trainer.num_update == 6


# ======================================================================
# the dist store's optimizer-state round trip (a shrink's resume)
def test_dist_kvstore_optimizer_state_roundtrip(tmp_path):
    with mt.cpu():
        kv = mt.kvstore.create("dist_sync_tpu")
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.init(3, mt.nd.array(np.ones((4, 4), "f")))
        kv.push(3, mt.nd.array(np.full((4, 4), 0.5, "f")))
        path = str(tmp_path / "dist.states")
        kv.save_optimizer_states(path)
        assert os.path.exists(path)
        kv2 = mt.kvstore.create("dist_sync_tpu")
        kv2.set_optimizer(mt.optimizer.SGD(learning_rate=0.1,
                                           momentum=0.9))
        kv2.load_optimizer_states(path)
    saved, restored = kv._updater.states, kv2._updater.states
    assert sorted(saved) == sorted(restored)
    for k in saved:
        if saved[k] is None:
            assert restored[k] is None
        else:
            np.testing.assert_array_equal(saved[k].asnumpy(),
                                          restored[k].asnumpy())


def test_kvstore_without_optimizer_still_refuses(tmp_path):
    kv = mt.kvstore.create("dist_sync_tpu")
    with pytest.raises(MXNetError, match="set_optimizer"):
        kv.save_optimizer_states(str(tmp_path / "x.states"))
    with pytest.raises(MXNetError, match="set_optimizer"):
        kv.load_optimizer_states(str(tmp_path / "x.states"))


# ======================================================================
# the launcher's drill: 2 -> host_dead -> 1 -> resume -> bitwise the
# one-process replay from the same checkpoint
@pytest.mark.slow
def test_elastic_shrink_resume_e2e(tmp_path):
    workdir = str(tmp_path / "work")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MXTPU_FAULTS="host_dead@step=11:rank=1")
    for k in ("MXTPU_COORDINATOR", "MXTPU_ELASTIC_DIR",
              "MXTPU_HEARTBEAT_DIR", "MXTPU_MODULE_FUSED"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"),
         "--local-elastic", "2", "--", sys.executable,
         str(ROOT / "tests" / "torch_elastic_train.py"), workdir,
         "--model", "mlp"],
        capture_output=True, text=True, timeout=420, env=env, cwd=str(ROOT))
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    assert "published membership epoch 2" in out, out
    assert "shrinking 2 -> 1" in out, out
    assert "auto-resume from checkpoint epoch" in out, out
    assert "elastic train done" in out, out
    assert "ELASTIC_RECOVERY_S=" in out, out
    with open(os.path.join(workdir, "resume-info.json")) as f:
        info = json.load(f)
    assert info["world"] == 1 and info["resumed_epoch"] >= 1
    env.pop("MXTPU_FAULTS")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_elastic_train.py"),
         workdir, "--model", "mlp", "--replay", str(info["resumed_epoch"])],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.load(os.path.join(workdir, "final.npz"))
    ref = np.load(os.path.join(workdir, "replay-final.npz"))
    assert sorted(got.files) == sorted(ref.files)
    for n in ref.files:
        assert np.array_equal(ref[n], got[n]), n
