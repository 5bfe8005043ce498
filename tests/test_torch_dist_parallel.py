"""The port's data-parallel training over worker processes on the CPU:
``tools/launch.py`` starts 2 and 4 gloo ranks running
``tests/torch_dist_workers.py``, and their numpy results are held
against the JAX package on an in-process CPU mesh of as many devices
(``mxnet_tpu/parallel``: ``lowp_allreduce``, the Trainer on a
``{"data": n}`` mesh) and against each other (ranks bitwise alike,
``zero=1`` bitwise ``zero=0``)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu.parallel.mesh import shard_map

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import mesh as tmesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# float32 sums in another order (the JAX Trainer's psum over its mesh)
REL_TOL = 1e-5
# the bfloat16 wire: both sides round each gradient to bfloat16 twice,
# from float32 local gradients that differ in their last bits
WIRE_REL_TOL = 2e-3


def _launch(n, suite, out):
    # one thread a rank: the ranks' work is small, and the test runs
    # beside other test processes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("MXTPU_MODULE_FUSED", None)
    subprocess.run([sys.executable, str(ROOT / "tools" / "launch.py"),
                    "-n", str(n), "--launcher", "local", "--",
                    sys.executable, str(ROOT / "tests" /
                                        "torch_dist_workers.py"),
                    suite, str(out)],
                   check=True, env=env, cwd=str(ROOT), timeout=240,
                   stdout=subprocess.DEVNULL)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch(2, "n2", tmp_path_factory.mktemp("dist2"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch(4, "n4", tmp_path_factory.mktemp("dist4"))


def _load(out, case, n):
    return [dict(np.load(out / ("%s-rank%d.npz" % (case, r))))
            for r in range(n)]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ----------------------------------------------------------------------
# collectives
@pytest.mark.parametrize("n", [2, 4])
def test_lowp_allreduce_is_the_jax_one_bitwise(n, two, four):
    """Each rank's ``lowp_allreduce`` (bfloat16 wire, float32 sum in rank
    order) equals the JAX package's under ``shard_map`` on n CPU devices,
    with and without ``keep_shard``, for leaves whose dim 0 divides by n
    and leaves (and a scalar) whose does not."""
    got = _load(two if n == 2 else four, "lowp", n)
    mesh = jpar.make_mesh({"data": n}, jax.devices()[:n])
    ins = [workers.lowp_inputs(r, n) for r in range(n)]
    for i in range(len(ins[0])):
        x = jnp.asarray(np.stack([ins[r][i] for r in range(n)]))
        for keep in (False, True):
            def f(xl, keep=keep):
                return jcoll.lowp_allreduce(xl[0], "data", n, jnp.bfloat16,
                                            keep_shard=keep)[None]
            want = np.asarray(shard_map(
                f, mesh=mesh, in_specs=PartitionSpec("data"),
                out_specs=PartitionSpec("data"), check_rep=False)(x))
            for r in range(n):
                np.testing.assert_array_equal(
                    got[r]["leaf%d_keep%d" % (i, keep)], want[r])


@pytest.mark.parametrize("shape,n,keep", [
    ((8, 3), 2, False), ((8, 3), 4, True), ((3, 5), 2, False),
    ((7,), 4, True), ((), 2, False), ((1024, 64), 8, True)])
def test_wire_byte_models_are_the_jax_ones(shape, n, keep):
    assert tcoll.lowp_comm_bytes(shape, n, 2, keep) == \
        jcoll.lowp_comm_bytes(shape, n, 2, keep)
    for prim in ("psum", "pmean", "psum_scatter", "reduce_scatter",
                 "all_gather", "all_to_all", "ppermute", "cond"):
        assert tcoll.collective_wire_bytes(prim, 1000, 4, n) == \
            jcoll.collective_wire_bytes(prim, 1000, 4, n)


def test_mesh_and_zero_spec_follow_the_jax_ones():
    """The port's ``zero_spec`` folds the data axis into the dim the JAX
    one does; meshes over ranks carry the ``data`` axis only."""
    for shape in [(16, 10), (3, 8), (3, 5), (7,), (), (4, 6, 2)]:
        want = jpar.mesh.zero_spec(PartitionSpec(), shape, 2)
        got = tmesh.zero_spec(tmesh.PartitionSpec(), shape, 2)
        assert tuple(got) == tuple(want) + (None,) * (len(got) - len(want))
    m = tmesh.make_mesh({"data": 1})
    assert (dict(m.shape), m.ranks, m.size) == ({"data": 1}, [0], 1)
    sharding = tmesh.batch_sharding(tmesh.make_mesh({"data": 2}, [0, 1]), 2)
    assert sharding.index((8, 3), rank=1) == (slice(4, 8), slice(0, 3))
    assert tmesh.global_data_parallel_mesh() is None
    with tmesh.use_mesh(m):
        assert tmesh.get_mesh() is m and tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None
    with pytest.raises(mt.MXNetError, match="item 7"):
        tmesh.make_mesh({"data": 1, "model": 1})


# ----------------------------------------------------------------------
# the fused Trainer over two ranks
def _jax_trainer(zero, wire, optimizer):
    """The JAX Trainer on a {"data": 2} mesh over the same global
    batches, from the same weights."""
    mesh = jpar.make_mesh({"data": 2}, jax.devices()[:2])
    opt = mx.optimizer.create(
        optimizer, learning_rate=0.1,
        rescale_grad=1.0 / workers.GLOBAL_BATCH,
        **({"momentum": 0.9} if optimizer == "sgd" else {}))
    t = jpar.Trainer(workers.mlp(mx.sym), opt, mesh=mesh, zero=zero,
                     grad_dtype=wire)
    b = workers.GLOBAL_BATCH
    t.bind(data_shapes={"data": (b, workers.MLP_IN)},
           label_shapes={"softmax_label": (b,)})
    t.init_params(arg_params=workers.mlp_params())
    x, y = workers.mlp_batches()
    for s in range(workers.STEPS):
        t.step({"data": x[s * b:(s + 1) * b],
                "softmax_label": y[s * b:(s + 1) * b]})
    return {k: np.asarray(v) for k, v in t.params.items()}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("zero,wire", [(0, "f32"), (1, "f32"), (0, "bf16"),
                                       (1, "bf16")])
def test_fused_trainer_ranks_agree_and_match_jax(two, zero, wire, optimizer):
    """Both ranks end bitwise alike, within 1e-5 (float32 wire) of the
    JAX Trainer on a two-device mesh over the same global batches."""
    ranks = _load(two, "trainer-z%d-%s-%s" % (zero, wire, optimizer), 2)
    want = _jax_trainer(zero, wire, optimizer)
    tol = REL_TOL if wire == "f32" else WIRE_REL_TOL
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[0]["p_" + k], ranks[1]["p_" + k])
        assert _rel(ranks[0]["p_" + k], v) < tol, k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_zero1_is_zero0_bitwise_with_half_the_state(two, optimizer):
    """``zero=1`` (reduce-scatter, the update on each rank's rows, an
    all-gather) ends bitwise where ``zero=0`` does; each rank holds half
    the optimizer state and sends half the gradient bytes."""
    z0 = _load(two, "trainer-z0-f32-%s" % optimizer, 2)[0]
    z1 = _load(two, "trainer-z1-f32-%s" % optimizer, 2)[0]
    for k in z0:
        if k.startswith(("p_", "outputs")):
            np.testing.assert_array_equal(z0[k], z1[k])
    assert int(z1["state_bytes"]) * 2 == int(z0["state_bytes"])
    assert int(z1["comm_bytes"]) * 2 == int(z0["comm_bytes"])
    # the saved blobs hold whole leaves either way
    s0 = pickle.loads(z0["blob"].tobytes())[1]
    s1 = pickle.loads(z1["blob"].tobytes())[1]
    for m in s0:
        for a, b in zip(mt.parallel.trainer._leaves(s0[m]),
                        mt.parallel.trainer._leaves(s1[m])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["0to1", "1to0"])
def test_states_blobs_restore_across_zero_settings(two, direction):
    """A replicated run's blob restores onto a ``zero=1`` run and the
    reverse (``test_old_replicated_blob_restores_onto_zero_run``)."""
    for r in _load(two, "blob-" + direction, 2):
        assert bool(r["same"])


def test_bf16_wire_keeps_the_float32_rows_under_zero1(two):
    """Under ``zero=1`` the bfloat16 wire keeps each rank's float32 sum
    (one rounding fewer than the gathered one): within the wire's
    tolerance of ``zero=0``'s bfloat16 run, and of the JAX one's."""
    z0 = _load(two, "trainer-z0-bf16-sgd", 2)[0]
    z1 = _load(two, "trainer-z1-bf16-sgd", 2)[0]
    for k in z0:
        if k.startswith("p_"):
            assert _rel(z1[k], z0[k]) < WIRE_REL_TOL
    assert int(z1["comm_bytes"]) < int(z0["comm_bytes"])


def _jax_conv_bn(wire):
    """The JAX Trainer's conv/BatchNorm run on a {"data": 2} mesh: its
    parameters and aux states."""
    mesh = jpar.make_mesh({"data": 2}, jax.devices()[:2])
    t = jpar.Trainer(workers.conv_bn(mx.sym), mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9,
        rescale_grad=1.0 / workers.GLOBAL_BATCH), mesh=mesh,
        grad_dtype=wire)
    b = workers.GLOBAL_BATCH
    t.bind(data_shapes={"data": (b,) + workers.CONV_IN},
           label_shapes={"softmax_label": (b,)})
    t.init_params(arg_params=workers.conv_bn_params(mx.sym))
    x, y = workers.conv_bn_batches()
    for s in range(workers.STEPS):
        t.step({"data": x[s * b:(s + 1) * b],
                "softmax_label": y[s * b:(s + 1) * b]})
    return {k: np.asarray(v) for k, v in
            list(t.params.items()) + list(t.aux.items())}


def test_batchnorm_by_rank_and_averaged_moving_statistics(two):
    """Under the bfloat16 wire each rank normalises BatchNorm by its own
    rows and the moving statistics are averaged over the ranks, as the
    JAX package's ``grad_dtype="bf16"`` step does on a two-device mesh
    (its backward shard_map'd, the aux states pmean'd): the parameters
    and the moving statistics within the wire's tolerance of it, the
    ranks bitwise."""
    ranks = _load(two, "conv-bn", 2)
    want = _jax_conv_bn("bf16")
    assert "bn1_moving_mean" in want
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        assert _rel(ranks[0][k], v) < WIRE_REL_TOL, (k, _rel(ranks[0][k], v))


@pytest.mark.parametrize("case", ["conv-bn-f32", "conv-bn-f32-z1",
                                  "conv-bn-f32-legacy", "conv-bn-f32-remat"])
def test_batchnorm_over_the_global_batch_at_the_float32_wire(two, case):
    """Under the float32 wire BatchNorm normalises by the whole global
    batch (its sums summed over the ranks in the forward and the
    backward), as the JAX package's step, one program over a two-device
    mesh, does: the parameters and the moving statistics within 1e-5 of
    it, the ranks bitwise, at zero 0 and 1, with autograd through the
    statistics (``dtype_policy="legacy"``) and with the forward
    recomputed in the backward (``remat="nothing"``, its sums again)."""
    ranks = _load(two, case, 2)
    want = _jax_conv_bn("f32")
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        assert _rel(ranks[0][k], v) < REL_TOL, (k, _rel(ranks[0][k], v))
    # the per-rank statistics are far from it
    per_rank = _load(two, "conv-bn", 2)[0]
    assert max(_rel(per_rank[k], v) for k, v in want.items()) \
        > 100 * REL_TOL


# ----------------------------------------------------------------------
# Module.fit with a dist_sync store
@pytest.mark.parametrize("path", ["classic", "fused", "mesh"])
def test_dist_sync_module_fit_matches_the_jax_trainer(two, path):
    """``Module.fit(kvstore="dist_sync")`` on each rank's rows (classic:
    the store sums the pushes over the ranks; fused: the step does; mesh:
    a ``Mesh`` over the ranks as the context, fused by default): the
    ranks end bitwise alike, within 1e-5 of the JAX Trainer on a
    two-device mesh stepping the same global batches (two epochs)."""
    ranks = _load(two, "module-" + path, 2)
    assert bool(ranks[0]["fused"]) == (path != "classic")
    mesh = jpar.make_mesh({"data": 2}, jax.devices()[:2])
    t = jpar.Trainer(workers.mlp(mx.sym), mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9,
        rescale_grad=1.0 / workers.GLOBAL_BATCH), mesh=mesh)
    b = workers.GLOBAL_BATCH
    t.bind(data_shapes={"data": (b, workers.MLP_IN)},
           label_shapes={"softmax_label": (b,)})
    t.init_params(arg_params=workers.mlp_params())
    x, y = workers.mlp_batches()
    for _ in range(2):
        for s in range(workers.STEPS):
            t.step({"data": x[s * b:(s + 1) * b],
                    "softmax_label": y[s * b:(s + 1) * b]})
    for k, v in t.params.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        assert _rel(ranks[0][k], np.asarray(v)) < REL_TOL, k


def test_resume_under_zero1_is_bitwise_the_straight_run(two):
    """Two epochs with a checkpoint a rank, then ``fit(resume=True)`` to
    three under ``MXTPU_ZERO=1``: bitwise the uninterrupted three
    epochs, the ranks alike."""
    ranks = _load(two, "resume", 2)
    for r in ranks:
        assert bool(r["zero_on"]) and bool(r["same"])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_dist_store_over_two_ranks(two):
    """``init``: rank 0's value wins; a push sums every rank's values;
    the store's heartbeats (the process group's store) see both ranks
    alive."""
    for r, res in enumerate(_load(two, "store", 2)):
        assert (int(res["rank"]), int(res["workers"])) == (r, 2)
        np.testing.assert_array_equal(res["init"], np.full(3, 10.0))
        np.testing.assert_array_equal(res["summed"], np.full(3, 5.0))
        assert int(res["dead"]) == 0
        assert list(res["kv_ranks"]) == [0, 1]
