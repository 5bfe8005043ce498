"""The port's RecordIO codec, its native image loader and ``mx.image``
against the JAX package's, on the CPU.

Records are tiny random JPEGs (at most 16, 40 x 48) made from a numpy
seed.  Everything here holds bitwise: record bytes and ``.idx`` lines,
``pack``/``unpack`` and the image codec, the native loader's batches
(the port builds its own copy, ``csrc/dataloader.cc``, which on a host
with libjpeg decodes as the JAX package's build does), and ``mx.image``
on uint8; the float functions to 1e-6."""
import io as pio
import random

import numpy as np
import pytest
from PIL import Image

from mxnet_tpu import image as jimage
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trio

N_RECORDS = 16
FLOAT_TOL = 1e-6


def _jpeg(rng, shape=(40, 48, 3)):
    buf = pio.BytesIO()
    Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``(rec, idx, payloads)``: N_RECORDS JPEG records written by the
    port, labels 0, 1, ..."""
    d = tmp_path_factory.mktemp("records")
    rec, idx = str(d / "img.rec"), str(d / "img.idx")
    rng = np.random.RandomState(0)
    payloads = [trio.pack(trio.IRHeader(0, float(i), i, 0), _jpeg(rng))
                for i in range(N_RECORDS)]
    w = trio.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    return rec, idx, payloads


def _payloads():
    """Records the framing must split: payloads holding the magic word at
    aligned offsets, at the start, at the end and twice, and an empty
    one."""
    magic = np.uint32(trio.kMagic).tobytes()
    rng = np.random.RandomState(1)
    body = [rng.bytes(n) for n in (13, 8, 0, 40)]
    return [body[0], magic + body[1], body[1] + magic,
            body[3][:8] + magic + body[3][8:16] + magic + body[3][16:],
            magic, body[2], body[3] + b"x"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_record_files_are_byte_identical_and_read_across(tmp_path, writer):
    files = {}
    for name, mod in (("port", trio), ("jax", jrio)):
        rec, idx = str(tmp_path / (name + ".rec")), \
            str(tmp_path / (name + ".idx"))
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(_payloads()):
            w.write_idx(i, p)
        w.close()
        files[name] = (rec, idx)
    for k in (0, 1):
        assert open(files["port"][k], "rb").read() == \
            open(files["jax"][k], "rb").read()
    rec, idx = files[writer]
    for mod in (trio, jrio):
        seq = mod.MXRecordIO(rec, "r")
        assert [seq.read() for _ in _payloads()] == _payloads()
        assert seq.read() is None
        seq.close()
        keyed = mod.MXIndexedRecordIO(idx, rec, "r")
        for i in reversed(range(len(_payloads()))):
            assert keyed.read_idx(i) == _payloads()[i]
        keyed.close()


@pytest.mark.parametrize("label", [3.0, [1.5, -2.0, 7.25]])
def test_pack_unpack_and_the_image_codec_are_exact(label):
    rng = np.random.RandomState(2)
    header = trio.IRHeader(0, label, 5, 9)
    assert trio.pack(header, b"abc") == jrio.pack(header, b"abc")
    for unpack in (trio.unpack, jrio.unpack):
        h, s = unpack(trio.pack(header, b"abc"))
        assert s == b"abc" and (h.id, h.id2) == (5, 9)
        np.testing.assert_array_equal(h.label, label)
    img = rng.randint(0, 255, (20, 24, 3), dtype=np.uint8)
    for fmt in (".jpg", ".png"):
        packed = trio.pack_img(header, img, quality=90, img_fmt=fmt)
        assert packed == jrio.pack_img(header, img, quality=90,
                                       img_fmt=fmt)
        (_, got), (_, want) = trio.unpack_img(packed), \
            jrio.unpack_img(packed)
        np.testing.assert_array_equal(got, want)
        if fmt == ".png":
            np.testing.assert_array_equal(got, img)


NATIVE_CASES = {
    "nchw_float32": dict(),
    "nhwc_uint8_crop_mirror": dict(layout="NHWC", dtype="uint8",
                                   rand_crop=True, rand_mirror=True),
    "nchw_mean_std_resize": dict(resize=36, mean_r=120.0, mean_g=110.0,
                                 mean_b=100.0, std_r=60.0, std_g=55.0,
                                 std_b=50.0, scale=0.5, rand_crop=True),
    "nhwc_uint8_part_1_of_2": dict(layout="NHWC", dtype="uint8",
                                   num_parts=2, part_index=1,
                                   rand_mirror=True),
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_loader_batches_are_the_jax_packages(records, case):
    """Two epochs, shuffled, 5 a batch (a padded last batch), seed 3: the
    port's build of its copy gives the JAX package's batches bit for
    bit."""
    rec, _, _ = records
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=5,
              shuffle=True, seed=3, output="numpy", preprocess_threads=2,
              **NATIVE_CASES[case])
    port, ref = tio.NativeImageRecordIter(**kw), \
        jio.NativeImageRecordIter(**kw)
    assert port.num_samples == ref.num_samples
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert a.pad == b.pad
            assert a.data[0].dtype == b.data[0].dtype
            np.testing.assert_array_equal(a.data[0], b.data[0])
            np.testing.assert_array_equal(a.label[0], b.label[0])
        port.reset()
        ref.reset()
    assert port.failures() == 0


def test_native_loader_output_ndarray_on_the_cpu(records):
    rec, _, _ = records
    with mt.cpu():
        it = tio.NativeImageRecordIter(rec, (3, 32, 32), 4)
        b = it.next()
    assert isinstance(b.data[0], mt.nd.NDArray)
    assert b.data[0].shape == (4, 3, 32, 32)
    assert it.provide_data[0].shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(b.label[0].asnumpy(), np.arange(4))


def test_image_record_iter_factory_chooses_as_the_jax_package(records):
    rec, _, _ = records
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4)
    with mt.cpu():
        assert isinstance(tio.ImageRecordIter(**kw),
                          tio.NativeImageRecordIter)
        py = tio.ImageRecordIter(random_h=10, **kw)
        assert isinstance(py, tio.PyImageRecordIter)
        py.close()
        forced = tio.ImageRecordIter(backend="python", **kw)
        assert isinstance(forced, tio.PyImageRecordIter)
        forced.close()
        with pytest.raises(mt.MXNetError, match="random_h"):
            tio.ImageRecordIter(backend="native", random_h=10, **kw)
        positional = tio.ImageRecordIter(rec, (3, 32, 32), 4)
        assert isinstance(positional, tio.NativeImageRecordIter)


def test_a_loader_that_cannot_build_raises(records, monkeypatch, tmp_path):
    """No fallback: a failed compile raises with the compiler's log, and
    a host with no JPEG decoder raises naming what is missing."""
    rec, _, _ = records
    broken = tmp_path / "dataloader.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "SOURCE", broken)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(mt.MXNetError, match="failed:[\\s\\S]*error"):
        tio.ImageRecordIter(rec, (3, 32, 32), 4, backend="native")
    monkeypatch.setattr(_native, "_has_header", lambda cxx, h: False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(mt.MXNetError, match="jpeglib.h"):
        tio.ImageRecordIter(rec, (3, 32, 32), 4)


# ----------------------------------------------------------------- image
def _photo(seed=4, shape=(30, 42, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape, np.uint8)


def _both(fn_name, *args, seed=0, **kw):
    """``fn_name`` of both packages on numpy inputs, each after seeding
    Python's and numpy's generators alike."""
    out = []
    for mod in (timage, jimage):
        random.seed(seed)
        np.random.seed(seed)
        out.append(getattr(mod, fn_name)(*args, **kw))
    return out


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL)


@pytest.mark.parametrize("call", [
    ("imresize", (20, 14), {}), ("imresize", (50, 33), {"interp": 1}),
    ("resize_short", (24,), {}), ("fixed_crop", (3, 4, 20, 16), {}),
    ("fixed_crop", (3, 4, 20, 16), {"size": (10, 8)}),
    ("center_crop", ((20, 16),), {}), ("random_crop", ((20, 16),), {}),
    ("random_size_crop", ((16, 16), 0.3, (0.75, 1.33)), {}),
    ("color_normalize", (np.array([120.0, 110.0, 100.0], np.float32),
                         np.array([60.0, 55.0, 50.0], np.float32)), {}),
])
def test_image_functions_match(call):
    name, args, kw = call
    for src in (_photo(), _photo().astype(np.float32) / 3.0):
        got, want = _both(name, src, *args, **kw)
        if isinstance(got, tuple):
            assert got[1] == want[1]
            got, want = got[0], want[0]
        _assert_same(got, want)


def test_imdecode_and_scale_down_match():
    buf = pio.BytesIO()
    Image.fromarray(_photo()).save(buf, format="PNG")
    for flag, rgb in ((1, True), (1, False), (0, True)):
        with mt.cpu():
            got = timage.imdecode(buf.getvalue(), flag=flag, to_rgb=rgb)
        want = jimage.imdecode(buf.getvalue(), flag=flag, to_rgb=rgb)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert timage.scale_down((20, 10), (30, 40)) == \
        jimage.scale_down((20, 10), (30, 40))


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=36, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(brightness=0.3, contrast=0.3, saturation=0.3, pca_noise=0.1,
         mean=np.array([1.0, 2.0, 3.0]), std=None),
])
def test_create_augmenter_pipelines_match(kw):
    got_augs, want_augs = _both("CreateAugmenter", (3, 24, 24), **kw)
    assert len(got_augs) == len(want_augs)
    for seed in range(3):
        got, want = [_photo(seed)], [_photo(seed)]
        random.seed(seed)
        np.random.seed(seed)
        for aug in got_augs:
            got = [o for s in got for o in aug(s)]
        random.seed(seed)
        np.random.seed(seed)
        for aug in want_augs:
            want = [o for s in want for o in aug(s)]
        assert len(got) == len(want) == 1
        _assert_same(got[0], want[0])
