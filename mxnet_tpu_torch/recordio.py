"""RecordIO (``mxnet_tpu/recordio.py``): the reference's packed binary
record format, in pure Python.

Wire format is dmlc-core's recordio (``src/io/iter_image_recordio*``,
``c_api.h:1408-1466``): every record is written as
``[kMagic][lrec][payload][pad-to-4]`` where ``lrec`` packs a 3-bit
continuation flag and a 29-bit length; a payload holding the magic word
is split at those words and rejoined on read.  Files written here are
byte-identical to the JAX package's and the reference's, and each reads
the other's ``.rec`` and ``.idx``.

``IRHeader``/``pack``/``unpack``/``pack_img``/``unpack_img`` mirror
``python/mxnet/recordio.py:170-260``; the image codec is Pillow's, as
the JAX package's is.  The JAX package's native codec (in its runtime
library, beside the engine) is not ported: this module reads and writes
the same bytes in Python.
"""
from __future__ import annotations

import io as _pyio
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "kMagic"]

kMagic = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", kMagic)
# the segment length is a 29-bit field
_MAX_SEGMENT = 1 << 29


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return lrec >> 29, lrec & (_MAX_SEGMENT - 1)


class MXRecordIO(object):
    """Sequential record reader/writer (reference ``recordio.py:19-97``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
            self.fio = open(self.uri, "wb")
        elif self.flag == "r":
            self.writable = False
            self.fio = open(self.uri, "rb")
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def close(self):
        if not getattr(self, "is_open", False):
            return
        self.fio.close()
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fio.tell()

    def seek_to(self, pos):
        """Position the reader at a byte offset (a record boundary)."""
        if self.writable:
            raise MXNetError("seek on a writer")
        self.fio.seek(pos)

    def write(self, buf):
        if not self.writable:
            raise MXNetError("recordio is read-only")
        data = memoryview(buf if isinstance(buf, bytes) else bytes(buf))
        if len(data) >= _MAX_SEGMENT:
            raise MXNetError("record of %d bytes exceeds the 29-bit segment "
                             "limit" % len(data))
        # split the payload at aligned magic words (dmlc RecordIOWriter)
        words = np.frombuffer(data[:len(data) // 4 * 4], dtype="<u4")
        cuts = [int(w) * 4 for w in np.nonzero(words == kMagic)[0]]
        starts = [0] + [c + 4 for c in cuts]
        ends = cuts + [len(data)]
        last = len(starts) - 1
        for i, (lo, hi) in enumerate(zip(starts, ends)):
            cflag = 0 if last == 0 else (1 if i == 0 else
                                         (3 if i == last else 2))
            seg = data[lo:hi]
            self.fio.write(_MAGIC_BYTES)
            self.fio.write(struct.pack("<I", _encode_lrec(cflag, len(seg))))
            self.fio.write(seg)
            self.fio.write(b"\x00" * ((-len(seg)) % 4))

    def read(self):
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise MXNetError("recordio is write-only")
        chunks = []
        while True:
            head = self.fio.read(8)
            if len(head) < 8:
                return b"".join(chunks) if chunks else None
            magic, lrec = struct.unpack("<II", head)
            if magic != kMagic:
                raise MXNetError("invalid record magic %x" % magic)
            cflag, length = _decode_lrec(lrec)
            payload = self.fio.read(length)
            self.fio.read((-length) % 4)
            if cflag == 0:
                return payload
            if chunks:
                chunks.append(_MAGIC_BYTES)
            chunks.append(payload)
            if cflag == 3:
                return b"".join(chunks)


class MXIndexedRecordIO(MXRecordIO):
    """Record file + ``.idx`` sidecar for random access
    (reference ``recordio.py:100-169``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not getattr(self, "is_open", False):
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def offsets(self):
        """Record start offsets in file order, from the loaded index."""
        return sorted(self.idx[k] for k in self.keys)

    def seek(self, idx):
        self.seek_to(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload (reference ``recordio.py:172-192``)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Unpack to (IRHeader, payload) (reference ``recordio.py:193-214``)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s, np.float32, header.flag))
        s = s[header.flag * 4:]
    return header, s


def _pil_image():
    try:
        from PIL import Image
    except ImportError as err:
        raise MXNetError("the image codec needs Pillow (PIL), which is not "
                         "installed") from err
    return Image


def unpack_img(s, iscolor=-1):
    """Unpack a packed image record to (IRHeader, HWC BGR uint8 array),
    reference ``recordio.py:215-237`` (cv2.imdecode semantics)."""
    Image = _pil_image()
    header, s = unpack(s)
    img = Image.open(_pyio.BytesIO(s))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1 or (iscolor == -1 and img.mode != "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[:, :, ::-1]  # RGB -> BGR, as the cv2-based reference
    return header, arr


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """JPEG- or PNG-encode an HWC BGR image array and pack it
    (reference ``recordio.py:238-269``)."""
    Image = _pil_image()
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB for Pillow
    pil = Image.fromarray(arr.astype(np.uint8))
    buf = _pyio.BytesIO()
    fmt = img_fmt.lower()
    if fmt in (".jpg", ".jpeg"):
        pil.save(buf, format="JPEG", quality=quality)
    elif fmt == ".png":
        pil.save(buf, format="PNG", compress_level=min(9, quality // 10))
    else:
        raise MXNetError("unsupported image format %s" % img_fmt)
    return pack(header, buf.getvalue())
