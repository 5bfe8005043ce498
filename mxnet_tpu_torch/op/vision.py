"""Vision ops (``mxnet_tpu/op/vision.py``): the SpatialTransformer family,
ROIPooling, Correlation and the imperative ``_imdecode``.

The JAX package leaves each to XLA as one vectorised program; here each
is the same formulation in PyTorch ops (gathers and masked reductions,
no per-element loops), so the CUDA path is PyTorch's kernels.  Maxima
reduce with ``amax``, whose gradient splits evenly among tied elements,
as JAX's ``max`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import Param, _REGISTRY, register


# ----------------------------------------------------------------------
# bilinear sampling core (shared by BilinearSampler / SpatialTransformer)
def _bilinear_gather(data, xs, ys):
    """data (N,C,H,W); xs/ys (N,Ho,Wo) source pixel coords.  Zero padding
    outside the image."""
    N, C, H, W = data.shape
    Ho, Wo = xs.shape[1:]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[:, None]  # (N,1,Ho,Wo)
    wy = (ys - y0)[:, None]
    flat = data.reshape(N, C, H * W)

    def corner(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.detach().clamp(0, W - 1).to(torch.int64)
        yc = yi.detach().clamp(0, H - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(N, 1, Ho * Wo).expand(N, C, Ho * Wo)
        g = flat.gather(2, idx).reshape(N, C, Ho, Wo)
        return g * valid[:, None].to(data.dtype)

    g00 = corner(y0, x0)
    g01 = corner(y0, x0 + 1)
    g10 = corner(y0 + 1, x0)
    g11 = corner(y0 + 1, x0 + 1)
    top = g00 * (1 - wx) + g01 * wx
    bot = g10 * (1 - wx) + g11 * wx
    return top * (1 - wy) + bot * wy


def _grid_to_coords(grid, H, W):
    """grid (N,2,Ho,Wo) in [-1,1] (x then y) to pixel coordinates."""
    xs = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return xs, ys


@register("BilinearSampler", input_names=("data", "grid"),
          hint="bilinearsampler")
def _bilinear_sampler(p, c, data, grid):
    xs, ys = _grid_to_coords(grid, data.shape[2], data.shape[3])
    return _bilinear_gather(data, xs, ys)


def _affine_grid(theta, H, W):
    """theta (N,6) -> sampling grid (N,2,H,W) in [-1,1]."""
    N = theta.shape[0]
    dev = theta.device
    yt, xt = torch.meshgrid(torch.linspace(-1, 1, H, device=dev),
                            torch.linspace(-1, 1, W, device=dev),
                            indexing="ij")
    coords = torch.stack([xt, yt, torch.ones_like(xt)], 0).reshape(3, H * W)
    mat = theta.reshape(N, 2, 3).to(coords.dtype)
    out = torch.einsum("nij,jk->nik", mat, coords)  # (N,2,H*W)
    return out.reshape(N, 2, H, W)


@register("GridGenerator",
          params_spec=(Param("transform_type", str, required=True,
                             enum=("affine", "warp")),
                       Param("target_shape", "shape", (0, 0))),
          hint="gridgenerator")
def _grid_generator(p, c, data):
    if p["transform_type"] == "affine":
        H, W = p["target_shape"]
        if H == 0 or W == 0:
            raise MXNetError("GridGenerator affine needs target_shape")
        return _affine_grid(data, H, W).to(data.dtype)
    # warp: data is an optical flow (N,2,H,W) in pixels; output normalized
    N, _, H, W = data.shape
    yt, xt = torch.meshgrid(torch.arange(H, device=data.device),
                            torch.arange(W, device=data.device),
                            indexing="ij")
    x = (data[:, 0] + xt) * (2.0 / max(W - 1, 1)) - 1.0
    y = (data[:, 1] + yt) * (2.0 / max(H - 1, 1)) - 1.0
    return torch.stack([x, y], 1).to(data.dtype)


def _gg_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    if p["transform_type"] == "affine":
        H, W = p["target_shape"]
        return [tuple(d)], [(d[0], 2, H, W)], []
    return [tuple(d)], [tuple(d)], []


_REGISTRY["GridGenerator"].infer_shape = _gg_infer_shape


@register("SpatialTransformer",
          params_spec=(Param("target_shape", "shape", (0, 0)),
                       Param("transform_type", str, "affine",
                             enum=("affine",)),
                       Param("sampler_type", str, "bilinear",
                             enum=("bilinear",))),
          input_names=("data", "loc"), hint="spatialtransformer")
def _spatial_transformer(p, c, data, loc):
    H, W = p["target_shape"]
    if H == 0 or W == 0:
        H, W = data.shape[2], data.shape[3]
    grid = _affine_grid(loc.float(), H, W)
    xs, ys = _grid_to_coords(grid, data.shape[2], data.shape[3])
    # coordinates stay float32 (bfloat16 spacing near 200 px is a pixel)
    return _bilinear_gather(data, xs, ys).to(data.dtype)


def _st_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    H, W = p["target_shape"]
    if H == 0 or W == 0:
        H, W = d[2], d[3]
    return [tuple(d), (d[0], 6)], [(d[0], d[1], H, W)], []


_REGISTRY["SpatialTransformer"].infer_shape = _st_infer_shape


# ----------------------------------------------------------------------
@register("ROIPooling",
          params_spec=(Param("pooled_size", "shape", required=True),
                       Param("spatial_scale", float, required=True)),
          input_names=("data", "rois"), hint="roipooling")
def _roi_pooling(p, c, data, rois):
    """Max pooling over roi bins: rois are ``[batch_idx, x1, y1, x2,
    y2]`` image coordinates scaled by ``spatial_scale``, inclusive; an
    empty bin gives 0.  Two masked maxima, over W per bin column, then
    over H per bin row; a tie splits the gradient evenly."""
    PH, PW = p["pooled_size"]
    scale = p["spatial_scale"]
    N, C, H, W = data.shape
    rois = rois.detach()
    batch_idx = rois[:, 0].to(torch.int64).clamp(0, N - 1)
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)  # (R,)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    # a true division: CUDA divides by a host scalar as a product with
    # its reciprocal, an ulp apart, and the bins' floor and ceil below
    # would then take another row or column
    bin_h = rh / torch.full((), PH, dtype=rh.dtype, device=rh.device)
    bin_w = rw / torch.full((), PW, dtype=rw.dtype, device=rw.device)

    ph = torch.arange(PH, dtype=data.dtype, device=data.device)
    pw = torch.arange(PW, dtype=data.dtype, device=data.device)
    ys_ = torch.floor(y1[:, None] + ph[None] * bin_h[:, None])    # (R,PH)
    ye_ = torch.ceil(y1[:, None] + (ph[None] + 1) * bin_h[:, None])
    xs_ = torch.floor(x1[:, None] + pw[None] * bin_w[:, None])    # (R,PW)
    xe_ = torch.ceil(x1[:, None] + (pw[None] + 1) * bin_w[:, None])

    rows = torch.arange(H, dtype=data.dtype, device=data.device)
    cols = torch.arange(W, dtype=data.dtype, device=data.device)
    in_y = (rows[None, None] >= ys_[..., None]) & \
        (rows[None, None] < ye_[..., None])                     # (R,PH,H)
    in_x = (cols[None, None] >= xs_[..., None]) & \
        (cols[None, None] < xe_[..., None])                     # (R,PW,W)

    roi_data = data.index_select(0, batch_idx)                  # (R,C,H,W)
    neg = float("-inf")
    # stage 1: masked max over W per pw -> (R,C,H,PW)
    a = torch.where(in_x[:, None, None, :, :], roi_data[:, :, :, None, :],
                    neg).amax(dim=-1)
    # stage 2: masked max over H per ph -> (R,C,PH,PW)
    out = torch.where(in_y[:, None, :, None, :],
                      a.movedim(2, -1)[:, :, None], neg).amax(dim=-1)
    return torch.where(torch.isfinite(out), out, 0.0).to(data.dtype)


def _roi_infer_shape(p, in_shapes):
    d, r = in_shapes
    if d is None or r is None:
        return None
    PH, PW = p["pooled_size"]
    return [tuple(d), tuple(r)], [(r[0], d[1], PH, PW)], []


_REGISTRY["ROIPooling"].infer_shape = _roi_infer_shape


# ----------------------------------------------------------------------
def _window_sum(x, K, s):
    """Sum over K x K windows at stride s of the last two axes (no
    padding)."""
    return x.unfold(-2, K, s).unfold(-2, K, s).sum(dim=(-1, -2))


@register("Correlation",
          params_spec=(Param("kernel_size", int, 1),
                       Param("max_displacement", int, 1),
                       Param("stride1", int, 1),
                       Param("stride2", int, 1),
                       Param("pad_size", int, 0),
                       Param("is_multiply", bool, True)),
          input_names=("data1", "data2"), num_outputs=1,
          hint="correlation")
def _correlation(p, c, data1, data2):
    """FlowNet correlation layer: for each displacement in a (2d+1)^2
    neighbourhood, the patch dot product of data1 and shifted data2."""
    K = p["kernel_size"]
    md = p["max_displacement"]
    s1, s2, pad = p["stride1"], p["stride2"], p["pad_size"]
    C = data1.shape[1]
    br = K // 2  # border needed for the kernel window
    d = md // s2
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    Hp, Wp = p1.shape[2], p1.shape[3]
    bsz = br + md
    Ho = int(np.ceil((Hp - 2 * bsz) / s1))
    Wo = int(np.ceil((Wp - 2 * bsz) / s1))
    norm = float(K * K * C)
    hy, wx = (Ho - 1) * s1 + K, (Wo - 1) * s1 + K
    sh1 = p1[:, :, bsz - br:bsz - br + hy, bsz - br:bsz - br + wx]
    planes = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = dy * s2, dx * s2
            sh2 = p2[:, :, bsz + oy - br:bsz + oy - br + hy,
                     bsz + ox - br:bsz + ox - br + wx]
            prod = (sh1 * sh2) if p["is_multiply"] else (sh1 - sh2).abs()
            planes.append(_window_sum(prod, K, s1).sum(dim=1) / norm)
    return torch.stack(planes, dim=1).to(data1.dtype)  # (N,D^2,Ho,Wo)


def _corr_infer_shape(p, in_shapes):
    d1 = in_shapes[0]
    if d1 is None:
        return None
    K, md = p["kernel_size"], p["max_displacement"]
    s1, s2, pad = p["stride1"], p["stride2"], p["pad_size"]
    D = 2 * (md // s2) + 1
    bsz = K // 2 + md
    Ho = int(math.ceil((d1[2] + 2 * pad - 2 * bsz) / s1))
    Wo = int(math.ceil((d1[3] + 2 * pad - 2 * bsz) / s1))
    return [tuple(d1), tuple(d1)], [(d1[0], D * D, Ho, Wo)], []


_REGISTRY["Correlation"].infer_shape = _corr_infer_shape


# ----------------------------------------------------------------------
# _imdecode: image decode as an operator (reference ``src/io/
# image_io.cc``).  Decoding is host-side by nature and its output shape
# depends on the payload, so the op is imperative-only: it reads a
# concrete uint8 buffer and returns the decoded HWC image on the
# buffer's device.
@register("_imdecode",
          params_spec=(Param("index", int, 0),
                       Param("x0", int, 0), Param("y0", int, 0),
                       Param("x1", int, 0), Param("y1", int, 0),
                       Param("c", int, 0), Param("size", int, 0),
                       Param("flag", int, 1),
                       Param("to_rgb", bool, True)),
          input_names=("buf",), hint="imdecode")
def _imdecode_op(p, ctx, buf):
    if buf.device.type == "meta":
        raise MXNetError(
            "_imdecode is imperative-only: image decoding is host-side "
            "and its output shape depends on the payload")
    from ..image import _imdecode_np
    raw = buf.detach().cpu().numpy().astype(np.uint8).tobytes()
    if p["size"]:
        raw = raw[:p["size"]]
    img = _imdecode_np(raw, p["flag"], p["to_rgb"])
    if p["x1"] > p["x0"] and p["y1"] > p["y0"]:
        img = img[p["y0"]:p["y1"], p["x0"]:p["x1"]]
    if p["c"] > 0:
        img = img[:, :, :p["c"]]
    return torch.from_numpy(np.array(img)).to(buf.device)
