"""``mx.image`` (``mxnet_tpu/image.py``): host-side image decode, resize
and augment.

API parity with the reference's ``python/mxnet/image.py`` (v0.9.5):
``imdecode`` (ref :26), ``scale_down`` (:45), ``resize_short`` (:56),
``fixed_crop`` (:66), ``random_crop`` (:74), ``center_crop`` (:86),
``color_normalize`` (:98), ``random_size_crop`` (:106), the augmenter
constructors (``ResizeAug`` :130 ... ``CastAug`` :261) and
``CreateAugmenter`` (:272).  Images are HWC uint8, decoded with Pillow
as the JAX package decodes them; ``to_rgb`` (default True) yields RGB.
Every function takes and returns an :class:`~mxnet_tpu_torch.ndarray.NDArray`
(on the current context) or a numpy array, whichever it was given; the
work runs on numpy.  ``ImageIter`` is not ported yet.
"""
import io as _pyio
import random as _pyrandom

import numpy as np

from . import ndarray as nd
from .base import MXNetError

__all__ = [
    "imdecode", "imread", "imresize", "scale_down", "resize_short",
    "fixed_crop", "random_crop", "center_crop", "color_normalize",
    "random_size_crop", "ResizeAug", "ForceResizeAug", "RandomCropAug",
    "RandomSizedCropAug", "CenterCropAug", "RandomOrderAug",
    "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
    "HorizontalFlipAug", "CastAug", "CreateAugmenter",
]


def _pil_image():
    try:
        from PIL import Image
    except ImportError as err:
        raise MXNetError("mx.image needs Pillow (PIL), which is not "
                         "installed") from err
    return Image


# PIL interpolation table indexed by the reference's cv2 interp enum
# (0=NEAREST 1=LINEAR 2=CUBIC 3=AREA 4=LANCZOS).
def _interp(flag):
    Image = _pil_image()
    return {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
            3: Image.BOX, 4: Image.LANCZOS}.get(int(flag), Image.BICUBIC)


def _to_np(src):
    return src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)


def _like(out, src):
    """Return ``out`` as the same container kind as ``src``: NDArray in →
    NDArray out (API parity), numpy in → numpy out (keeps the ImageIter hot
    path host-side — no per-sample device transfers)."""
    return nd.array(out, dtype=out.dtype) if isinstance(src, nd.NDArray) \
        else out


def _imdecode_np(buf, flag=1, to_rgb=True):
    Image = _pil_image()
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_pyio.BytesIO(bytes(buf)))
    if int(flag) == 0:
        return np.asarray(img.convert("L"), dtype=np.uint8)[:, :, None]
    arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    return arr if to_rgb else arr[:, :, ::-1]


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode a compressed image buffer to an HWC uint8 NDArray.

    Mirrors ``image.py:26-42`` (cv2.imdecode + BGR→RGB flip).  ``flag=0``
    decodes grayscale (HW1)."""
    return nd.array(_imdecode_np(buf, flag, to_rgb), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file and decode it (convenience over :func:`imdecode`)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=2):
    """Resize HWC image to (h, w), the counterpart of ``mx.nd.imresize``
    (``src/io/image_io.cc``).  Accepts uint8 or float input (the
    reference's cv2.resize handles both)."""
    Image = _pil_image()
    arr = _to_np(src)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    if arr.dtype == np.uint8:
        pil = Image.fromarray(arr[:, :, 0] if squeeze else arr)
        out = np.asarray(pil.resize((int(w), int(h)), _interp(interp)))
    elif arr.ndim == 2:
        out = np.asarray(
            Image.fromarray(arr.astype(np.float32), mode="F")
            .resize((int(w), int(h)), _interp(interp))).astype(arr.dtype)
    else:
        # PIL can't build a multi-channel float image; resize channel-wise
        # through float32 'F' mode planes
        planes = [np.asarray(
            Image.fromarray(arr[:, :, c].astype(np.float32), mode="F")
            .resize((int(w), int(h)), _interp(interp)))
            for c in range(arr.shape[2])]
        out = np.stack(planes, axis=2).astype(arr.dtype)
        squeeze = False
    if squeeze:
        out = out[:, :, None]
    return _like(out.astype(arr.dtype), src)


def scale_down(src_size, size):
    """Scale ``size`` down to fit in ``src_size``, keeping aspect ratio
    (contract of ``image.py:45-53``)."""
    w, h = size
    sw, sh = src_size
    # shrink each overflowing edge in turn, dragging the other with it
    if sh < h:
        w = float(w * sh) / h
        h = sh
    if sw < w:
        h = float(h * sw) / w
        w = sw
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge equals ``size`` (``image.py:56-63``)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop ``[y0:y0+h, x0:x0+w]`` then optionally resize
    (``image.py:66-71``)."""
    arr = _to_np(src)
    out = arr[int(y0):int(y0) + int(h), int(x0):int(x0) + int(w)]
    if size is not None and (w, h) != size:
        return _like(_to_np(imresize(out, size[0], size[1], interp=interp)),
                     src)
    return _like(out, src)


def random_crop(src, size, interp=2):
    """Random crop to ``size`` (scaled down if needed); returns
    ``(img, (x0, y0, w, h))`` (``image.py:74-83``)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop to ``size``; returns ``(img, roi)`` (``image.py:86-95``)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32 (``image.py:98-103``); either
    stat may be None."""
    arr = _to_np(src).astype(np.float32)
    if mean is not None:
        arr -= _to_np(mean)
    if std is not None:
        arr /= _to_np(std)
    return _like(arr, src)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area+aspect-ratio crop, falling back to :func:`random_crop`
    (``image.py:106-127``)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    area = w * h
    for _ in range(10):
        new_area = _pyrandom.uniform(min_area, 1.0) * area
        new_ratio = _pyrandom.uniform(*ratio)
        new_w = int(np.sqrt(new_area * new_ratio))
        new_h = int(np.sqrt(new_area / new_ratio))
        if _pyrandom.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return random_crop(src, size, interp)


# --- closure-style augmenters (reference ``image.py:130-269``) ---

def ResizeAug(size, interp=2):
    """Short-edge resize augmenter."""
    return lambda src: [resize_short(src, size, interp)]


def ForceResizeAug(size, interp=2):
    """Exact-size resize augmenter (ignores aspect ratio)."""
    return lambda src: [imresize(src, size[0], size[1], interp)]


def RandomCropAug(size, interp=2):
    """Random-position crop augmenter."""
    return lambda src: [random_crop(src, size, interp)[0]]


def RandomSizedCropAug(size, min_area, ratio, interp=2):
    """Random area/aspect crop augmenter (inception-style)."""
    return lambda src: [random_size_crop(src, size, min_area, ratio,
                                         interp)[0]]


def CenterCropAug(size, interp=2):
    """Center crop augmenter."""
    return lambda src: [center_crop(src, size, interp)[0]]


def RandomOrderAug(ts):
    """Apply a list of augmenter lists in random order (``image.py:170-181``)."""
    def aug(src):
        srcs = [src]
        _pyrandom.shuffle(ts)
        for t in ts:
            srcs = [img for s in srcs for img in t(s)]
        return srcs
    return aug


def ColorJitterAug(brightness, contrast, saturation):
    """Random brightness/contrast/saturation jitter (``image.py:184-221``)."""
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def baug(src):
        alpha = 1.0 + _pyrandom.uniform(-brightness, brightness)
        return [_to_np(src).astype(np.float32) * alpha]

    def caug(src):
        alpha = 1.0 + _pyrandom.uniform(-contrast, contrast)
        arr = _to_np(src).astype(np.float32)
        gray = (arr * coef).sum(axis=2, keepdims=True).mean() * (1.0 - alpha)
        return [arr * alpha + gray]

    def saug(src):
        alpha = 1.0 + _pyrandom.uniform(-saturation, saturation)
        arr = _to_np(src).astype(np.float32)
        gray = (arr * coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return [arr * alpha + gray]

    ts = []
    if brightness > 0:
        ts.append(baug)
    if contrast > 0:
        ts.append(caug)
    if saturation > 0:
        ts.append(saug)
    return RandomOrderAug(ts)


def LightingAug(alphastd, eigval, eigvec):
    """PCA-lighting noise (AlexNet-style; ``image.py:224-234``)."""
    def aug(src):
        alpha = np.random.normal(0, alphastd, size=(3,))
        rgb = np.dot(_to_np(eigvec) * alpha, _to_np(eigval))
        return [(_to_np(src) + rgb).astype(np.float32)]
    return aug


def ColorNormalizeAug(mean, std):
    mean_np = None if mean is None else _to_np(mean).astype(np.float32)
    std_np = None if std is None else _to_np(std).astype(np.float32)

    def aug(src):
        arr = _to_np(src).astype(np.float32)
        if mean_np is not None:
            arr = arr - mean_np
        if std_np is not None:
            arr = arr / std_np
        return [arr]
    return aug


def HorizontalFlipAug(p):
    def aug(src):
        if _pyrandom.random() < p:
            return [_to_np(src)[:, ::-1, :]]
        return [_to_np(src)]
    return aug


def CastAug():
    def aug(src):
        return [_to_np(src).astype(np.float32)]
    return aug


# ImageNet RGB statistics and PCA lighting basis — the constants the
# reference augmenter chain bakes in (mean=True/std=True select them)
_IMAGENET_RGB_MEAN = np.array([123.68, 116.28, 103.53])
_IMAGENET_RGB_STD = np.array([58.395, 57.12, 57.375])
_IMAGENET_PCA_EIGVAL = np.array([55.46, 4.794, 1.148])
_IMAGENET_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                                 [-0.5808, -0.0045, -0.8140],
                                 [-0.5836, -0.6948, 0.4203]])


def _channel_stat(value, imagenet_default):
    """``True`` -> the ImageNet constant; ``None`` -> disabled; anything
    else -> a 1- or 3-channel array."""
    if value is True:
        return imagenet_default
    if value is None:
        return None
    value = _to_np(value)
    assert value.shape[0] in (1, 3)
    return value


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Assemble the standard training augmentation pipeline in the
    reference's fixed stage order (contract of ``image.py:272-318``):
    resize -> crop -> flip -> cast -> color jitter -> pca lighting ->
    normalize."""
    pipeline = []
    if resize > 0:
        pipeline.append(ResizeAug(resize, inter_method))
    crop = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        pipeline.append(RandomSizedCropAug(crop, 0.3,
                                           (3.0 / 4.0, 4.0 / 3.0),
                                           inter_method))
    else:
        pipeline.append(RandomCropAug(crop, inter_method) if rand_crop
                        else CenterCropAug(crop, inter_method))
    if rand_mirror:
        pipeline.append(HorizontalFlipAug(0.5))
    pipeline.append(CastAug())
    if brightness or contrast or saturation:
        pipeline.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        pipeline.append(LightingAug(pca_noise, _IMAGENET_PCA_EIGVAL,
                                    _IMAGENET_PCA_EIGVEC))
    mean = _channel_stat(mean, _IMAGENET_RGB_MEAN)
    std = _channel_stat(std, _IMAGENET_RGB_STD)
    if mean is not None or std is not None:
        pipeline.append(ColorNormalizeAug(mean, std))
    return pipeline
