"""Decode worker process of the streaming input pipeline
(``mxnet_tpu/_decode_worker.py``).

``io.PyImageRecordIter(preprocess_mode="process")`` spawns N of these
(the multi-process half of the reference's OMP decode parser,
``iter_image_recordio_2.cc:104-120``: decode parallelism with no GIL).
Each worker owns a reader over the RecordIO file, seeks the byte offsets
of the batches assigned to it, decodes JPEG and runs the spatial
augments (resize / random-or-center crop / mirror) at uint8, and writes
the finished uint8 NHWC batch into its slot of a
``multiprocessing.shared_memory`` ring.  Colour math (normalisation,
scale, dtype) does not happen here: raw bytes cross the host-to-device
wire and ``io.StreamAugmentIter`` or the fused trainer's cast finishes
the pipeline on the device.  A worker never touches a CUDA device.

Ring protocol (one ring per worker, ``depth`` slots):

* parent -> worker: ``task_q`` items ``(epoch, seq, offsets, pad,
  indices)``, one per batch; ``None`` shuts the worker down.
* worker -> parent: ``result_q`` items ``("ok", wid, epoch, seq, slot,
  labels, pad, indices)`` or ``("err", wid, epoch, seq, exc,
  traceback_str)``.
* ``free_sem`` counts free slots; the worker acquires before writing
  slot ``k % depth`` and the parent releases after copying the slab
  out.  Slots are written and read in the same per-worker order.
* ``epoch_val`` is the parent's current epoch (-1: shutting down): a
  worker drops tasks of a stale epoch, and a worker parked on a full
  ring re-checks it, so a mid-epoch ``reset()`` cannot deadlock.
"""
from __future__ import annotations

import os
import struct
import threading  # noqa: F401  (multiprocessing.Queue uses it at fork)

import numpy as np


def spatial_augment(img, h, w, resize, rand_crop, rand_mirror, rng):
    """resize → (up-size) → crop → mirror, all at uint8 HWC.

    The spatial half of ``image_aug_default.cc`` shared by the thread
    and process decode paths (the thread path appends normalize +
    CHW transpose; the process path ships these bytes as-is)."""
    from PIL import Image
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=2)
    if resize > 0:
        ih, iw = img.shape[:2]
        short = min(ih, iw)
        ratio = resize / short
        pil = Image.fromarray(img[:, :, ::-1])
        pil = pil.resize((max(w, int(iw * ratio)),
                          max(h, int(ih * ratio))), Image.BILINEAR)
        img = np.asarray(pil)[:, :, ::-1]
    ih, iw = img.shape[:2]
    if ih < h or iw < w:
        pil = Image.fromarray(img[:, :, ::-1])
        pil = pil.resize((max(w, iw), max(h, ih)), Image.BILINEAR)
        img = np.asarray(pil)[:, :, ::-1]
        ih, iw = img.shape[:2]
    if rand_crop:
        y = rng.randint(0, ih - h + 1)
        x = rng.randint(0, iw - w + 1)
    else:
        y = (ih - h) // 2
        x = (iw - w) // 2
    img = img[y:y + h, x:x + w]
    if rand_mirror and rng.rand() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img, dtype=np.uint8)


def _batch_rng(seed, epoch, seq):
    """Deterministic per-batch RNG: same (seed, epoch, batch) augments
    identically however batches land on workers."""
    mixed = (int(seed) + 0x9E3779B1 * (int(seq) + 1)
             + 0x85EBCA6B * (int(epoch) + 1)) & 0x7FFFFFFF
    return np.random.RandomState(mixed)


def _picklable(exc):
    import pickle
    try:
        pickle.dumps(exc)
        return exc
    except Exception:                       # noqa: BLE001
        return RuntimeError(repr(exc))


def worker_main(cfg, task_q, result_q, free_sem, epoch_val):
    """Entry point of one decode worker process."""
    from mxnet_tpu_torch import faults as _faults
    from mxnet_tpu_torch import recordio as _rio

    wid = cfg["wid"]
    depth = cfg["depth"]
    h, w = cfg["crop"]
    label_width = cfg["label_width"]
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=cfg["shm_name"])
    reader = None
    slab = None
    k = 0                                   # batches actually decoded
    try:
        reader = _rio.MXRecordIO(cfg["rec_path"], "r")
        slab = np.ndarray((depth,) + tuple(cfg["slab_shape"]),
                          dtype=np.uint8, buffer=shm.buf)
        while True:
            task = task_q.get()
            if task is None:
                return
            epoch, seq, offsets, pad, idxs = task
            if epoch != epoch_val.value:    # stale epoch: drop cheaply
                continue
            # park on the ring, bailing out if the epoch goes stale so
            # a mid-epoch reset cannot deadlock us against the consumer
            acquired = False
            while not acquired:
                acquired = free_sem.acquire(timeout=0.1)
                if not acquired and epoch != epoch_val.value:
                    break
            if not acquired:
                continue
            if epoch != epoch_val.value:
                free_sem.release()
                continue
            slot = k % depth
            try:
                rng = _batch_rng(cfg["seed"], epoch, seq)
                labels = np.zeros((len(offsets), label_width), np.float32)
                for j, off in enumerate(offsets):
                    if _faults.hit("io_error", site="decode_worker",
                                   batch=seq):
                        raise OSError(
                            "injected io_error in decode worker %d at "
                            "batch %d" % (wid, seq))
                    reader.seek_to(off)
                    header, img = _rio.unpack_img(reader.read())
                    if header.flag > 0:
                        lab = np.asarray(header.label,
                                         np.float32).ravel()
                        labels[j, :min(label_width, lab.size)] = \
                            lab[:label_width]
                    else:
                        labels[j, 0] = np.float32(header.label)
                    slab[slot, j] = spatial_augment(
                        img, h, w, cfg["resize"], cfg["rand_crop"],
                        cfg["rand_mirror"], rng)
                k += 1
                result_q.put(("ok", wid, epoch, seq, slot, labels, pad,
                              np.asarray(idxs, np.int64)))
            except BaseException as e:      # noqa: BLE001
                # the slot was never published: hand it back, ship the
                # ORIGINAL exception (+ formatted traceback) upstream
                free_sem.release()
                import traceback
                result_q.put(("err", wid, epoch, seq, _picklable(e),
                              traceback.format_exc()))
    finally:
        try:
            if reader is not None:
                reader.close()
        except Exception:                   # noqa: BLE001
            pass
        slab = None                         # release the exported buffer
        try:
            shm.close()
        except BufferError:
            pass


def _decode_lrec(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


def scan_offsets(path):
    """Sequential scan of record start offsets (the no-``.idx``
    fallback; the indexed path is ``MXIndexedRecordIO.offsets()``)."""
    offsets = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        pos = 0
        while pos < size:
            offsets.append(pos)
            while True:
                head = f.read(8)
                if len(head) < 8:
                    pos = size
                    break
                _, lrec = struct.unpack("<II", head)
                cflag, length = _decode_lrec(lrec)
                f.seek(length + ((-length) % 4), 1)
                pos = f.tell()
                if cflag in (0, 3):
                    break
    return offsets
