#!/usr/bin/env python3
"""Probe the port's native image loader on this machine.

    python3 tools/torch_loader_probe.py

Builds ``mxnet_tpu_torch/csrc/dataloader.cc`` (the libjpeg route where
libjpeg's header is found, else nvJPEG), writes ``bench.py``'s record file
(512 random 256 x 256 JPEGs at quality 90, seed 0) and small files in each
chroma subsampling (4:4:4, 4:2:2, 4:2:0) to a temporary directory, and
prints, one JSON object a line:

* the host: libjpeg's and libpng's headers on g++'s path, their
  libraries in ``ldconfig -p``, nvJPEG in the CUDA toolkit, g++'s version,
  Pillow's and OpenCV's versions and the core count;
* the JPEG route, PNG support and the build's seconds;
* each decoded batch against Pillow's decode of the same JPEGs (the
  libjpeg route's pixels, bit for bit): largest and mean absolute error;
* decode img/s of the loader alone at 8 and 4 threads, and Pillow's on one
  thread;
* with a CUDA card, the median ms of one pinned 256 x 224 x 224 x 3 uint8
  upload, and the card's name and power limit.
"""
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from mxnet_tpu_torch import _native, io as mio, recordio  # noqa: E402


def write_rec(path, images, subsampling=-1):
    """Pack ``images`` (HWC RGB uint8) as JPEG records labelled 0, 1, ...;
    returns the JPEG bytes."""
    out, rec = [], recordio.MXRecordIO(path, "w")
    for i, img in enumerate(images):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                  subsampling=subsampling)
        out.append(buf.getvalue())
        rec.write(recordio.pack(recordio.IRHeader(0, float(i % 1000), i, 0),
                                buf.getvalue()))
    rec.close()
    return out


def pillow_bgr(jpeg):
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))[:, :, ::-1]


def errors(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())}


def host():
    """What this host offers the loader's build."""
    cxx = _native._cxx()
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                          text=True).stdout
    found = {}
    for mod in ("PIL", "cv2"):
        try:
            found[mod] = __import__(mod).__version__
        except ImportError:
            found[mod] = None
    return {"jpeglib.h": _native._has_header(cxx, "jpeglib.h"),
            "png.h": _native._has_header(cxx, "png.h"),
            "libjpeg": "libjpeg." in libs, "libpng": "libpng" in libs,
            "nvjpeg.h": os.path.exists(os.path.join(
                _native._cuda_home(), "include", "nvjpeg.h")),
            "cxx": subprocess.run([cxx, "--version"], capture_output=True,
                                  text=True).stdout.splitlines()[0],
            **found, "cpu_count": os.cpu_count()}


def main():
    print(json.dumps({"host": host()}), flush=True)
    t0 = time.perf_counter()
    lib = _native.dataloader_lib()
    print(json.dumps({"jpeg_route": _native.jpeg_route(),
                      "png": bool(lib.mxt_loader_has_png()),
                      "build_s": time.perf_counter() - t0,
                      "cpu_count": os.cpu_count()}), flush=True)
    tmp = tempfile.mkdtemp()
    rng = np.random.RandomState(0)
    bench = [rng.randint(0, 255, (256, 256, 3), dtype=np.uint8)
             for _ in range(512)]
    rec = os.path.join(tmp, "bench.rec")
    jpegs = write_rec(rec, bench)
    it = mio.NativeImageRecordIter(rec, (3, 256, 256), 256, layout="NHWC",
                                   dtype="uint8", output="numpy",
                                   preprocess_threads=os.cpu_count())
    batch = it.next()
    want = np.stack([pillow_bgr(j) for j in jpegs[:256]])
    print(json.dumps({"bench_batch_vs_pillow": errors(batch.data[0], want),
                      "failures": it.failures()}), flush=True)
    shapes = [(31, 45), (64, 64), (17, 90), (100, 33)]
    for sub in (0, 1, 2):
        imgs = [rng.randint(0, 255, s + (3,), dtype=np.uint8)
                for s in shapes]
        path = os.path.join(tmp, "sub%d.rec" % sub)
        for k, jpeg in enumerate(write_rec(path, imgs, subsampling=sub)):
            want = pillow_bgr(jpeg)
            one = mio.NativeImageRecordIter(
                path, (3,) + want.shape[:2], 1, layout="NHWC", dtype="uint8",
                output="numpy", preprocess_threads=1)
            for _ in range(k):
                one.next()
            print(json.dumps({"subsampling": sub, "shape": want.shape,
                              **errors(one.next().data[0][0], want)}),
                  flush=True)
    for threads in (8, 4):
        it = mio.NativeImageRecordIter(rec, (3, 224, 224), 256,
                                       rand_crop=True, layout="NHWC",
                                       dtype="uint8", output="numpy",
                                       preprocess_threads=threads)
        it.next()
        t0, n = time.perf_counter(), 0
        while n < 1024:
            try:
                it.next()
                n += 256
            except StopIteration:
                it.reset()
        print(json.dumps({"decode_threads": threads,
                          "img_per_s": n / (time.perf_counter() - t0)}),
              flush=True)
    t0 = time.perf_counter()
    for jpeg in jpegs[:128]:
        pillow_bgr(jpeg)
    print(json.dumps({"pillow_one_thread_img_per_s":
                      128 / (time.perf_counter() - t0)}), flush=True)
    import torch
    if torch.cuda.is_available():
        pinned = torch.empty((256, 224, 224, 3), dtype=torch.uint8,
                             pin_memory=True)
        dst = torch.empty(pinned.shape, dtype=torch.uint8, device="cuda")
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"h2d_ms_median": sorted(times)[3] * 1e3,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
