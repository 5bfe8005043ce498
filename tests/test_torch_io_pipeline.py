"""The port's input pipeline on the CPU against the JAX package's: the
Python record iterator in thread and process modes, the wrappers
(``ResizeIter``, ``PrefetchingIter``), the staging stage
(``DeviceUploadIter``), the on-device augment (``StreamAugmentIter``,
``DeviceCacheIter``) and the reference's ``MNISTIter``/``CSVIter``.

Inputs are tiny records (10 JPEGs of 40 x 36) and frames made from a
numpy seed.  Bitwise: the record iterators' batches, shuffles and
labels, the staged batches, the cache's shuffled order and the augment
without randomness; mean/std to 1e-6.  The augment's random offsets and
flips come from a ``torch.Generator`` in the port and from threefry keys
in the JAX package, so they are checked by determinism per seed, by
their moments and by being literal windows of their frames."""
import io as pio
import time

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio

N_THREADS = 2
N_WORKERS = 2
FLOAT_TOL = 1e-6


@pytest.fixture(scope="module")
def rec_with_idx(tmp_path_factory):
    """10 JPEG records + .idx sidecar (40 x 36 frames, label i)."""
    d = tmp_path_factory.mktemp("pipeline_rec")
    rec, idx = str(d / "img.rec"), str(d / "img.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(3)
    for i in range(10):
        buf = pio.BytesIO()
        Image.fromarray(rng.randint(0, 255, (40, 36, 3), dtype=np.uint8)
                        ).save(buf, format="JPEG", quality=95)
        w.write_idx(i, jrio.pack(jrio.IRHeader(0, float(i), i, 0),
                                 buf.getvalue()))
    w.close()
    return rec, idx


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.pad == b.pad
        np.testing.assert_array_equal(a.data[0], b.data[0])
        np.testing.assert_array_equal(a.label[0], b.label[0])


@pytest.mark.parametrize("kw", [
    dict(preprocess_threads=N_THREADS),
    # the decode threads share one RandomState, so the random augments'
    # draws follow the threads' order: one thread makes it deterministic
    dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=5,
         preprocess_threads=1),
    dict(resize=34, mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=60.0,
         scale=0.5, round_batch=False, preprocess_threads=N_THREADS),
], ids=["plain", "shuffle_crop_mirror", "resize_normalise"])
def test_thread_mode_matches_the_jax_package(rec_with_idx, kw):
    rec, idx = rec_with_idx
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
                batch_size=4, output="numpy", **kw)
    port, ref = tio.PyImageRecordIter(**args), jio.PyImageRecordIter(**args)
    for _ in range(2):                                  # two epochs
        _assert_batches_equal(list(port), list(ref))
        port.reset()
        ref.reset()
    port.close()
    ref.close()


def test_process_mode_matches_the_jax_package(rec_with_idx):
    """Process workers emit uint8 NHWC batches bit for bit the JAX
    package's (the per-batch seeds are shared), over two shuffled
    epochs with random crops and mirrors."""
    rec, idx = rec_with_idx
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
                batch_size=4, shuffle=True, rand_crop=True,
                rand_mirror=True, seed=2, preprocess_mode="process",
                decode_workers=N_WORKERS, output="numpy")
    port, ref = tio.PyImageRecordIter(**args), jio.PyImageRecordIter(**args)
    try:
        assert port.provide_data[0].dtype == np.uint8
        for _ in range(2):
            got, want = list(port), list(ref)
            assert got[0].data[0].shape == (4, 32, 32, 3)
            _assert_batches_equal(got, want)
            port.reset()
            ref.reset()
    finally:
        port.close()
        ref.close()
    assert port._ring is None


def test_process_mode_refuses_normalisation_and_propagates_a_crash(
        rec_with_idx, monkeypatch):
    rec, idx = rec_with_idx
    for bad in (dict(mean_r=123.0), dict(scale=1 / 255.)):
        with pytest.raises(mt.MXNetError, match="identity"):
            tio.PyImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                                  data_shape=(3, 32, 32), batch_size=4,
                                  preprocess_mode="process", **bad)
    # set before the spawn, so the worker inherits it
    monkeypatch.setenv("MXTPU_FAULTS", "io_error@decode_worker")
    it = tio.PyImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
        batch_size=4, preprocess_mode="process", decode_workers=1,
        output="numpy")
    try:
        with pytest.raises(OSError, match="injected io_error") as err:
            it.next()
        assert "decode worker traceback" in str(err.value.__cause__)
        assert "worker_main" in str(err.value.__cause__)
        # the stream goes on past the bad batch
        np.testing.assert_array_equal(it.next().label[0],
                                      np.arange(4, 8, dtype=np.float32))
    finally:
        it.close()


def test_thread_mode_ndarray_output_and_sharding(rec_with_idx):
    rec, idx = rec_with_idx
    with mt.cpu():
        it = tio.PyImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                   batch_size=2, num_parts=3, part_index=0,
                                   preprocess_threads=N_THREADS)
        labels = [b.label[0].asnumpy() for b in it]
    it.close()
    assert isinstance(it.provide_data[0], tio.DataDesc)
    np.testing.assert_array_equal(np.concatenate(labels), [0, 1, 2, 3])


# ---------------------------------------------------------------- wrappers
def _ndarray_iters(n=10, batch=4):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.float32)
    with mt.cpu():
        port = tio.NDArrayIter(x, y, batch_size=batch)
    return port, mx.io.NDArrayIter(x, y, batch_size=batch)


def _values(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _assert_values_equal(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_resize_and_prefetching_iters_match(monkeypatch):
    port, ref = _ndarray_iters()
    _assert_values_equal(_values(tio.ResizeIter(port, 7)),
                         _values(jio.ResizeIter(ref, 7)))
    for naive in (False, True):
        if naive:
            monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
        port, ref = _ndarray_iters()
        port2, ref2 = _ndarray_iters()
        pf = tio.PrefetchingIter([port, port2],
                                 rename_data=[{"data": "a"}, {"data": "b"}])
        want_pf = jio.PrefetchingIter([ref, ref2],
                                      rename_data=[{"data": "a"},
                                                   {"data": "b"}])
        assert [d.name for d in pf.provide_data] == ["a", "b"]
        for _ in range(2):
            got = [[a.asnumpy() for a in b.data] for b in pf]
            want = [[a.asnumpy() for a in b.data] for b in want_pf]
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            pf.reset()
            want_pf.reset()
        assert (pf._producers is None) == naive


def test_prefetching_iter_raises_a_producer_error_and_goes_on():
    class Flaky(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.n = 0
            self.provide_data = [tio.DataDesc("data", (2, 3))]
            self.provide_label = [tio.DataDesc("softmax_label", (2,))]

        def next(self):
            self.n += 1
            if self.n == 2:
                raise OSError("flaky read")
            if self.n > 4:
                raise StopIteration
            return tio.DataBatch([np.full((2, 3), self.n)], [], pad=0)

    pf = tio.PrefetchingIter(Flaky())
    assert pf.next().data[0][0, 0] == 1
    with pytest.raises(OSError, match="flaky"):
        pf.next()
    assert [b.data[0][0, 0] for b in pf] == [3, 4]


# ---------------------------------------------------------------- staging
class _HostSource(tio.DataIter):
    """``n`` host batches ``x + k`` (k = 1, 2, ...) and labels ``y``."""

    def __init__(self, x, y, n):
        super().__init__(x.shape[0])
        self.x, self.y, self.n, self.k = x, y, n, 0
        self.provide_data = [tio.DataDesc("data", x.shape, x.dtype)]
        self.provide_label = [tio.DataDesc("softmax_label", y.shape)]

    def next(self):
        if self.k >= self.n:
            raise StopIteration
        self.k += 1
        return tio.DataBatch([self.x + self.x.dtype.type(self.k)],
                             [self.y], pad=0)

    def reset(self):
        self.k = 0


@pytest.mark.parametrize("dtype,chunks", [(np.uint8, 4), (np.float32, 3)])
def test_chunked_upload_equals_unchunked(dtype, chunks):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 200, (10, 5, 3)).astype(dtype)
    y = np.arange(10, dtype=np.float32)
    outs = {}
    for k in (1, chunks):
        with mt.cpu():
            up = tio.DeviceUploadIter(_HostSource(x, y, 5), chunks=k,
                                      chunk_min_bytes=0)
        outs[k] = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in up]
        assert up.stats()["batches_staged"] == 5
        up.reset()
        assert len(list(up)) == 5                       # a second epoch
    for (a, la), (b, lb), k in zip(outs[1], outs[chunks], range(1, 6)):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, x + dtype(k))
        np.testing.assert_array_equal(la, lb)


def test_upload_stays_depth_ahead():
    """With a fast producer and a slow consumer the queue holds ``depth``
    staged batches, and stats() attributes the stages."""
    depth = 3
    x = np.zeros((2, 3), np.float32)
    with mt.cpu():
        up = tio.DeviceUploadIter(_HostSource(x, np.zeros(2, np.float32),
                                              12), depth=depth, chunks=2)
    up.next()                                           # starts the worker
    deadline = time.time() + 10.0
    while up._q.qsize() < depth and time.time() < deadline:
        time.sleep(0.01)
    assert up._q.qsize() == depth
    n = 1
    for _ in up:
        time.sleep(0.02)                                # a slow consumer
        n += 1
    assert n == 12
    st = up.stats()
    assert st["batches_staged"] == 12
    assert st["depth"] == depth and st["chunks"] == 2
    assert st["ready_ahead_frac"] >= 0.75
    assert set(st) == {"upload_s", "source_s", "decode_wait_s",
                       "consumer_wait_s", "ready_ahead_frac",
                       "batches_staged", "chunks", "depth"}


# ------------------------------------------------------- on-device augment
FRAMES = np.random.RandomState(7).randint(
    0, 255, (12, 10, 12, 3)).astype(np.uint8)


class _Frames(tio.DataIter):
    """FRAMES (uint8 NHWC) in batches of 4, labels 0..11."""

    def __init__(self, batch=4):
        super().__init__(batch)
        self.k = 0
        self.provide_data = [tio.DataDesc("data", (batch, 10, 12, 3),
                                          np.uint8)]
        self.provide_label = [tio.DataDesc("softmax_label", (batch,))]

    def next(self):
        if self.k >= len(FRAMES):
            raise StopIteration
        lo, self.k = self.k, self.k + self.batch_size
        return tio.DataBatch([FRAMES[lo:self.k]],
                             [np.arange(lo, self.k, dtype=np.float32)],
                             pad=0)

    def reset(self):
        self.k = 0


class _JaxFrames(_Frames, jio.DataIter):
    pass


def _port(cls, *args, **kw):
    with mt.cpu():
        return cls(*args, **kw)


STATS = dict(mean=(10.0, 20.0, 30.0), std=(2.0, 4.0, 5.0))


@pytest.mark.parametrize("stats", [{}, STATS], ids=["uint8", "mean_std"])
def test_center_crop_matches_the_jax_package(stats):
    for port, ref in (
            (_port(tio.StreamAugmentIter, _Frames(), data_shape=(6, 8),
                   **stats),
             jio.StreamAugmentIter(_JaxFrames(), data_shape=(6, 8),
                                   **stats)),
            (_port(tio.DeviceCacheIter, _Frames(), data_shape=(6, 8),
                   batch_size=5, **stats),
             jio.DeviceCacheIter(_JaxFrames(), data_shape=(6, 8),
                                 batch_size=5, **stats))):
        assert port.provide_data[0].shape == ref.provide_data[0].shape
        assert np.dtype(port.provide_data[0].dtype) == \
            np.dtype(ref.provide_data[0].dtype)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.pad == b.pad
            g, w = a.data[0].asnumpy(), b.data[0].asnumpy()
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=0)
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())


def test_cache_shuffles_as_the_jax_package():
    port = _port(tio.DeviceCacheIter, _Frames(), shuffle=True, seed=9,
                 batch_size=5)
    ref = jio.DeviceCacheIter(_JaxFrames(), shuffle=True, seed=9,
                              batch_size=5)
    assert port.cache_nbytes() == ref.cache_nbytes() == FRAMES.nbytes + 48
    for _ in range(3):                                   # three epochs
        got = np.concatenate([b.label[0].asnumpy() for b in port])
        want = np.concatenate([b.label[0].asnumpy() for b in ref])
        np.testing.assert_array_equal(got, want)
        port.reset()
        ref.reset()


def _draws(make, batches=40):
    """Every batch of a fresh iterator from ``make()``, its
    ``(images, labels, oy, ox, flip)``, wrapping its epochs."""
    it, out = make(), []
    while len(out) < batches:
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            continue
        oy, ox, flip = (t.numpy() for t in it.last_draw)
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy().astype(int),
                    oy, ox, flip))
    return out


@pytest.mark.parametrize("cls", ["stream", "cache"])
def test_random_crops_and_flips_are_seeded_windows(cls):
    def make(seed):
        if cls == "stream":
            return lambda: _port(tio.StreamAugmentIter, _Frames(),
                                 data_shape=(6, 8), rand_crop=True,
                                 rand_mirror=True, seed=seed)
        return lambda: _port(tio.DeviceCacheIter, _Frames(),
                             data_shape=(6, 8), rand_crop=True,
                             rand_mirror=True, shuffle=True, seed=seed,
                             batch_size=4)

    runs = _draws(make(3)), _draws(make(3)), _draws(make(4))
    for a, b in zip(runs[0], runs[1]):                 # one seed, one stream
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert any(not np.array_equal(a[2], b[2])
               for a, b in zip(runs[0], runs[2]))
    oy, ox, flip = (np.concatenate([r[k] for r in runs[0]])
                    for k in (2, 3, 4))
    assert set(oy) == set(range(5)) and set(ox) == set(range(5))
    assert abs(oy.mean() - 2.0) < 0.3 and abs(ox.mean() - 2.0) < 0.3
    assert abs(flip.mean() - 0.5) < 0.1
    for imgs, labels, oy, ox, flip in runs[0]:
        for img, lab, y, x, f in zip(imgs, labels, oy, ox, flip):
            want = FRAMES[lab, y:y + 6, x:x + 8]
            np.testing.assert_array_equal(img, want[:, ::-1] if f else want)


def test_augment_refuses_bad_shapes():
    with pytest.raises(mt.MXNetError, match="exceeds"):
        _port(tio.StreamAugmentIter, _Frames(), data_shape=(11, 8))
    with pytest.raises(mt.MXNetError, match="channels"):
        _port(tio.DeviceCacheIter, _Frames(), mean=(1.0, 2.0))


def test_stream_over_upload_over_process_decode(rec_with_idx):
    """The stream wiring in miniature, on the CPU: process decode ->
    DeviceUploadIter -> StreamAugmentIter, against the thread path's
    float batches."""
    rec, idx = rec_with_idx
    proc = tio.PyImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
        batch_size=4, preprocess_mode="process", decode_workers=1,
        output="numpy")
    thread = tio.PyImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
        batch_size=4, preprocess_threads=N_THREADS, output="numpy")
    try:
        up = _port(tio.DeviceUploadIter, proc, depth=2, chunks=2,
                   chunk_min_bytes=0)
        it = _port(tio.StreamAugmentIter, up, **STATS)
        got = [b.data[0].asnumpy() for b in it]
        want = [(b.data[0].transpose(0, 2, 3, 1)
                 - np.float32(STATS["mean"])) / np.float32(STATS["std"])
                for b in thread]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    finally:
        proc.close()
        thread.close()


# -------------------------------------------------------------- MNIST, CSV
def test_mnist_and_csv_iters_match(tmp_path):
    import gzip
    import struct
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (50, 28, 28), dtype=np.uint8)
    lbl = rng.randint(0, 10, 50).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lbl")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 50, 28, 28) + img.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 50) + lbl.tobytes())
    for kw in (dict(), dict(flat=True, shuffle=False),
               dict(num_parts=2, part_index=1, seed=3)):
        with mt.cpu():
            port = tio.MNISTIter(image=ip, label=lp, batch_size=16,
                                 silent=True, **kw)
        ref = jio.MNISTIter(image=ip, label=lp, batch_size=16, silent=True,
                            **kw)
        assert port.provide_data[0].shape == ref.provide_data[0].shape
        _assert_values_equal(_values(port), _values(ref))
    data = rng.normal(0, 1, (10, 6)).astype(np.float32)
    dp, lp = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dp, data, delimiter=",")
    np.savetxt(lp, np.arange(10), delimiter=",")
    for kw in (dict(label_csv=lp), dict(round_batch=False)):
        with mt.cpu():
            port = tio.CSVIter(data_csv=dp, data_shape=(2, 3), batch_size=4,
                               **kw)
        ref = jio.CSVIter(data_csv=dp, data_shape=(2, 3), batch_size=4, **kw)
        _assert_values_equal(_values(port), _values(ref))
    with pytest.raises(mt.MXNetError, match="invalid MNIST"):
        tio.MNISTIter(image=lp, label=lp)
