"""Contrib ops (``mxnet_tpu/op/contrib.py``): the SSD MultiBox family,
Faster R-CNN's Proposal, count_sketch and fft/ifft.

Everything keeps a fixed shape, as the JAX package's programs do: NMS
is a fixed number of suppression rounds, the matching and the sorts are
tensor ops, and empty slots are ``-1`` rows as the reference pads its
outputs.  Nothing reads a device value on the host (no ``.item()``, no
``nonzero``), so a graph of these ops can be captured in a CUDA graph.
Orders follow the JAX ops': ``argmax`` takes the first of equal values,
sorts are stable, and the top-k is a stable descending sort, which takes
the lower index first among equal scores as ``lax.top_k`` does.  NMS
computes the IoU row of each kept box when it is kept, the same values
the JAX op reads from its whole IoU matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import Param, _REGISTRY, alias, register


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient
    reaches tensor bounds and splits at a tie, as JAX's does."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _full_like(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


# ----------------------------------------------------------------------
# MultiBoxPrior
@register("MultiBoxPrior",
          params_spec=(Param("sizes", "floats", (1.0,)),
                       Param("ratios", "floats", (1.0,)),
                       Param("clip", bool, False),
                       Param("steps", "floats", (-1.0, -1.0)),
                       Param("offsets", "floats", (0.5, 0.5))),
          hint="multiboxprior")
def _multibox_prior(p, c, data):
    sizes, ratios = p["sizes"], p["ratios"]
    steps, offsets = p["steps"], p["offsets"]
    H, W = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # (H,W)
    # anchors: num_sizes + num_ratios - 1 per pixel, (s_i, r_0) for
    # every size, then (s_0, r_j) for j > 0
    whs = [(sizes[i] * np.sqrt(ratios[0]), sizes[i] / np.sqrt(ratios[0]))
           for i in range(len(sizes))]
    whs += [(sizes[0] * np.sqrt(ratios[j]), sizes[0] / np.sqrt(ratios[j]))
            for j in range(1, len(ratios))]
    boxes = [torch.stack([cxg - float(w) / 2, cyg - float(h) / 2,
                          cxg + float(w) / 2, cyg + float(h) / 2], dim=-1)
             for w, h in whs]
    out = torch.stack(boxes, dim=2).reshape(1, H * W * len(whs), 4)
    if p["clip"]:
        out = out.clamp(0.0, 1.0)
    return out.to(data.dtype)


def _mbp_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    na = len(p["sizes"]) + len(p["ratios"]) - 1
    return [tuple(d)], [(1, d[2] * d[3] * na, 4)], []


_REGISTRY["MultiBoxPrior"].infer_shape = _mbp_infer_shape


# ----------------------------------------------------------------------
def _iou(a, b):
    """Corner boxes ``a (..., A, 1, 4)`` against ``b (..., 1, M, 4)`` (or
    any broadcast of the two) -> IoU ``(..., A, M)``."""
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _encode_loc(anchors, gt, variances):
    """Center-form offset targets (reference multibox_target-inl.h)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-8)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    v = [torch.full((), x, dtype=gw.dtype, device=gw.device)
         for x in variances]     # true divisions, as the JAX op's
    tx = (gcx - acx) / torch.clamp(aw, min=1e-8) / v[0]
    ty = (gcy - acy) / torch.clamp(ah, min=1e-8) / v[1]
    tw = torch.log(gw / torch.clamp(aw, min=1e-8)) / v[2]
    th = torch.log(gh / torch.clamp(ah, min=1e-8)) / v[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


@register("MultiBoxTarget",
          params_spec=(Param("overlap_threshold", float, 0.5),
                       Param("ignore_label", float, -1.0),
                       Param("negative_mining_ratio", float, -1.0),
                       Param("negative_mining_thresh", float, 0.5),
                       Param("minimum_negative_samples", int, 0),
                       Param("variances", "floats", (0.1, 0.1, 0.2, 0.2))),
          input_names=("anchor", "label", "cls_pred"), num_outputs=3,
          output_names=lambda p: ["loc_target", "loc_mask", "cls_target"],
          hint="multiboxtarget")
def _multibox_target(p, c, anchor, label, cls_pred):
    """Anchor-to-gt matching, every sample of the batch at once: greedy
    bipartite for each gt (one round a gt slot, each taking the best
    remaining pair), then the IoU threshold for the other anchors, and
    hard-negative mining ranked by the best non-background score."""
    variances = p["variances"]
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N, M = label.shape[0], label.shape[1]
    dev = anchor.device
    cls_id = label[..., 0]                                  # (N,M)
    gt = label[..., 1:5]                                    # (N,M,4)
    valid_gt = cls_id >= 0
    iou = _iou(anchors[None, :, None, :].detach(), gt[:, None].detach())
    iou = torch.where(valid_gt[:, None], iou, -1.0)         # (N,A,M)

    match = torch.full((N, A), -1, dtype=torch.int64, device=dev)
    iou_m = iou
    rows = torch.arange(A, device=dev)
    cols = torch.arange(M, device=dev)
    for _ in range(M):
        flat = iou_m.reshape(N, -1).argmax(dim=1)           # (N,)
        ai, mi = flat // M, flat % M
        best = iou_m.reshape(N, -1).gather(1, flat[:, None])[:, 0]
        ok = best > 1e-12
        cur = match.gather(1, ai[:, None])[:, 0]
        match = match.scatter(1, ai[:, None],
                              torch.where(ok, mi, cur)[:, None])
        hit_row = (rows[None] == ai[:, None]) & ok[:, None]   # (N,A)
        hit_col = (cols[None] == mi[:, None]) & ok[:, None]   # (N,M)
        iou_m = torch.where(hit_row[:, :, None] | hit_col[:, None, :],
                            -1.0, iou_m)
    # threshold matching for the anchors left (on the original IoU)
    best_m = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    match = torch.where((match < 0) & (best_iou >= p["overlap_threshold"]),
                        best_m, match)

    matched = match >= 0
    mi = match.clamp(0, M - 1)
    gt_m = gt.gather(1, mi[..., None].expand(N, A, 4))
    loc_t = _encode_loc(anchors[None], gt_m, variances)
    loc_t = torch.where(matched[..., None], loc_t, 0.0)
    loc_m = matched[..., None].to(loc_t.dtype).expand(N, A, 4)
    cls_t = torch.where(matched, cls_id.gather(1, mi) + 1.0, 0.0)

    ratio = p["negative_mining_ratio"]
    if ratio > 0:
        # negatives are mineable only when their best IoU is below
        # negative_mining_thresh; ranked by the best non-background
        # score
        mineable = ~matched & (best_iou < p["negative_mining_thresh"])
        neg_conf = cls_pred.detach()[:, 1:].amax(dim=1)      # (N,A)
        neg_conf = torch.where(mineable, neg_conf, float("-inf"))
        order = torch.argsort(-neg_conf, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, rows[None].expand(N, A).contiguous())
        num_pos = matched.sum(dim=1)
        num_neg = torch.clamp((ratio * num_pos).to(torch.int32),
                              min=p["minimum_negative_samples"])
        keep_neg = mineable & (rank < num_neg[:, None])
        cls_t = torch.where(matched, cls_t,
                            torch.where(keep_neg, 0.0, p["ignore_label"]))
    dt = anchor.dtype
    return (loc_t.reshape(N, -1).to(dt), loc_m.reshape(N, -1).to(dt),
            cls_t.to(dt))


def _mbt_infer_shape(p, in_shapes):
    a, lab, _ = in_shapes
    if a is None or lab is None:
        return None
    A = a[1]
    N = lab[0]
    return [tuple(s) for s in in_shapes], \
        [(N, A * 4), (N, A * 4), (N, A)], []


_REGISTRY["MultiBoxTarget"].infer_shape = _mbt_infer_shape


# ----------------------------------------------------------------------
def _decode_boxes(anchors, loc, variances):
    """Inverse of _encode_loc: offsets -> corner boxes (..., 4)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _nms_keep(boxes, scores, iou_thresh, max_steps, cls=None):
    """Greedy NMS over each row of ``boxes (N,A,4)``/``scores (N,A)``, in
    ``max_steps`` suppression rounds: the keep mask ``(N,A)``.  With
    ``cls`` a box suppresses only boxes of its own class."""
    N, A = scores.shape
    boxes = boxes.detach()
    scores = scores.detach()
    idx = torch.arange(A, device=scores.device)
    avail = scores > float("-inf")
    keep = torch.zeros_like(avail)
    for _ in range(max_steps):
        s = torch.where(avail, scores, float("-inf"))
        i = s.argmax(dim=1)                                 # (N,)
        ok = s.gather(1, i[:, None])[:, 0] > float("-inf")
        pick = (idx[None] == i[:, None]) & ok[:, None]
        keep = keep | pick
        box_i = boxes.gather(1, i[:, None, None].expand(N, 1, 4))
        iou_i = _iou(box_i, boxes)                          # (N,A)
        if cls is not None:
            same = cls.gather(1, i[:, None]) == cls
            iou_i = torch.where(same, iou_i, 0.0)
        avail = avail & ~(iou_i > iou_thresh) & (idx[None] != i[:, None])
        avail = avail & ok[:, None]
    return keep


@register("MultiBoxDetection",
          params_spec=(Param("clip", bool, True),
                       Param("threshold", float, 0.01),
                       Param("background_id", int, 0),
                       Param("nms_threshold", float, 0.5),
                       Param("force_suppress", bool, False),
                       Param("variances", "floats", (0.1, 0.1, 0.2, 0.2)),
                       Param("nms_topk", int, -1)),
          input_names=("cls_prob", "loc_pred", "anchor"),
          hint="multiboxdetection")
def _multibox_detection(p, c, cls_prob, loc_pred, anchor):
    """Decode + NMS -> (N, A, 6) rows [cls_id, score, x1, y1, x2, y2];
    suppressed and invalid rows have cls_id = -1, kept rows first in
    score order."""
    variances = p["variances"]
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N = cls_prob.shape[0]
    bg = p["background_id"]
    steps = p["nms_topk"] if p["nms_topk"] > 0 else min(A, 400)
    # the winning foreground class per anchor
    fg_mask = torch.zeros(cls_prob.shape[1], 1, dtype=torch.bool,
                          device=cls_prob.device)
    fg_mask[bg] = True
    prob_fg = torch.where(fg_mask, -1.0, cls_prob)
    cls = prob_fg.argmax(dim=1).to(torch.float32)           # (N,A)
    score = prob_fg.amax(dim=1)
    boxes = _decode_boxes(anchors[None], loc_pred.reshape(N, A, 4),
                          variances)
    if p["clip"]:
        boxes = _clip(boxes, _full_like(boxes, 0.0), _full_like(boxes, 1.0))
    valid = score > p["threshold"]
    s = torch.where(valid, score, float("-inf"))
    keep = _nms_keep(boxes, s, p["nms_threshold"], steps,
                     cls=None if p["force_suppress"] else cls)
    out_id = torch.where(cls > bg, cls - 1.0, cls)
    out_cls = torch.where(keep, out_id, -1.0)
    row = torch.cat([out_cls[..., None].to(score.dtype), score[..., None],
                     boxes.to(score.dtype)], dim=-1)
    # kept rows first, by score
    order = torch.argsort(torch.where(keep, -score.detach(), float("inf")),
                          dim=1, stable=True)
    return row.gather(1, order[..., None].expand(N, A, 6)) \
        .to(cls_prob.dtype)


def _mbd_infer_shape(p, in_shapes):
    cp = in_shapes[0]
    if cp is None:
        return None
    return [tuple(s) for s in in_shapes], [(cp[0], cp[2], 6)], []


_REGISTRY["MultiBoxDetection"].infer_shape = _mbd_infer_shape


# ----------------------------------------------------------------------
def _base_anchors(scales, ratios, stride, device):
    """Proposal's (K, 4) base anchors around one stride x stride cell,
    in float64 as numpy makes them, on ``device`` with no host copy."""
    f64 = dict(dtype=torch.float64, device=device)
    r = torch.stack([torch.full((), float(x), **f64) for x in ratios])
    s = torch.stack([torch.full((), float(x), **f64) for x in scales])
    ws = torch.round(torch.sqrt(stride * stride / r))[:, None]   # (R,1)
    hs = torch.round(ws * r[:, None])
    w2 = (ws * s[None] - 1) / 2                                   # (R,S)
    h2 = (hs * s[None] - 1) / 2
    cx = (stride - 1) / 2.0
    return torch.stack([cx - w2, cx - h2, cx + w2, cx + h2],
                       -1).reshape(-1, 4).float()


@register("Proposal",
          params_spec=(Param("rpn_pre_nms_top_n", int, 6000),
                       Param("rpn_post_nms_top_n", int, 300),
                       Param("threshold", float, 0.7),
                       Param("rpn_min_size", int, 16),
                       Param("scales", "floats", (4.0, 8.0, 16.0, 32.0)),
                       Param("ratios", "floats", (0.5, 1.0, 2.0)),
                       Param("feature_stride", int, 16),
                       Param("output_score", bool, False),
                       Param("iou_loss", bool, False)),
          input_names=("cls_prob", "bbox_pred", "im_info"),
          num_outputs=lambda p: 2 if p.get("output_score") else 1,
          output_names=lambda p: (["output", "score"]
                                  if p.get("output_score") else ["output"]),
          hint="proposal")
def _proposal(p, c, cls_prob, bbox_pred, im_info):
    """RPN proposals: anchors on the feature grid, deltas decoded,
    clipped to the image, boxes under ``rpn_min_size`` dropped, the
    top ``rpn_pre_nms_top_n`` by score, NMS, padded to
    ``rpn_post_nms_top_n`` by cycling the kept set."""
    scales, ratios = p["scales"], p["ratios"]
    stride = p["feature_stride"]
    N, _, H, W = cls_prob.shape
    K = len(scales) * len(ratios)
    post_n = p["rpn_post_nms_top_n"]
    pre_n = p["rpn_pre_nms_top_n"]
    dev = cls_prob.device
    base = _base_anchors(scales, ratios, stride, dev)       # (K,4)
    sx = torch.arange(W, dtype=torch.float32, device=dev) * stride
    sy = torch.arange(H, dtype=torch.float32, device=dev) * stride
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([sxg, syg, sxg, syg], -1).reshape(H * W, 1, 4)
    anchors = (shift + base[None]).reshape(-1, 4)           # (H*W*K,4)
    A = anchors.shape[0]

    # cls_prob (N,2K,H,W): its second half is foreground; deltas (4K,H,W)
    fg = cls_prob[:, K:].permute(0, 2, 3, 1).reshape(N, -1)  # (N,A)
    dl = bbox_pred.reshape(N, K, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]           # (N,1)
    wide = torch.stack([anchors[:, 0], anchors[:, 1], anchors[:, 2] + 1.0,
                        anchors[:, 3] + 1.0], -1)
    boxes = _decode_boxes(wide[None], dl, (1.0, 1.0, 1.0, 1.0))
    zero = _full_like(boxes, 0.0)
    boxes = torch.stack([_clip(boxes[..., 0], zero, im_w - 1),
                         _clip(boxes[..., 1], zero, im_h - 1),
                         _clip(boxes[..., 2], zero, im_w - 1),
                         _clip(boxes[..., 3], zero, im_h - 1)], -1)
    min_size = p["rpn_min_size"] * im_info[:, 2:3].detach()
    wv = boxes[..., 2] - boxes[..., 0] + 1
    hv = boxes[..., 3] - boxes[..., 1] + 1
    valid = (wv >= min_size) & (hv >= min_size)
    score = torch.where(valid, fg, float("-inf"))
    # the top k by score, the lower index first among equal scores
    k = min(pre_n, A)
    top_i = torch.sort(score.detach(), dim=1, descending=True,
                       stable=True).indices[:, :k]
    top_s = score.gather(1, top_i)
    top_b = boxes.gather(1, top_i[..., None].expand(N, k, 4))
    keep = _nms_keep(top_b, top_s, p["threshold"], min(post_n, k))
    # kept rows first (score order); pad slots cycle the kept set
    order = torch.argsort(torch.where(keep, -top_s.detach(), float("inf")),
                          dim=1, stable=True)
    num_keep = torch.clamp(keep.sum(dim=1, keepdim=True), min=1)
    slot = torch.arange(post_n, device=dev)[None] % num_keep
    src = order.gather(1, slot.clamp(0, k - 1))
    out_b = top_b.gather(1, src[..., None].expand(N, post_n, 4))
    out_s = top_s.gather(1, src)
    batch_idx = torch.arange(N, dtype=cls_prob.dtype, device=dev)[:, None] \
        .expand(N, post_n)
    rois = torch.cat([batch_idx[..., None], out_b.to(cls_prob.dtype)], -1) \
        .reshape(N * post_n, 5)
    if p["output_score"]:
        return rois, out_s.reshape(N * post_n, 1)
    return rois


def _proposal_infer_shape(p, in_shapes):
    cp = in_shapes[0]
    if cp is None:
        return None
    N = cp[0]
    post_n = p["rpn_post_nms_top_n"]
    outs = [(N * post_n, 5)]
    if p["output_score"]:
        outs.append((N * post_n, 1))
    return [tuple(s) for s in in_shapes], outs, []


_REGISTRY["Proposal"].infer_shape = _proposal_infer_shape
alias("_contrib_Proposal", "Proposal")
alias("_contrib_MultiBoxPrior", "MultiBoxPrior")
alias("_contrib_MultiBoxTarget", "MultiBoxTarget")
alias("_contrib_MultiBoxDetection", "MultiBoxDetection")


# ----------------------------------------------------------------------
@register("count_sketch",
          params_spec=(Param("out_dim", int, required=True),
                       Param("processing_batch_size", int, 32)),
          input_names=("data", "h", "s"), hint="countsketch")
def _count_sketch(p, c, data, h, s):
    """Count-sketch projection: ``out[n, h[j]] += s[j] * data[n, j]``,
    one index-add."""
    out_dim = p["out_dim"]
    idx = h.detach().reshape(-1).to(torch.int64).clamp(0, out_dim - 1)
    vals = data * s.reshape(1, -1).to(data.dtype)
    out = torch.zeros(data.shape[0], out_dim, dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, vals)


def _cs_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return [tuple(s) for s in in_shapes], [(d[0], p["out_dim"])], []


_REGISTRY["count_sketch"].infer_shape = _cs_infer_shape
alias("_contrib_count_sketch", "count_sketch")


@register("fft", params_spec=(Param("compute_size", int, 128),),
          hint="fft")
def _fft(p, c, data):
    """FFT over the last axis; the complex result interleaved [re, im],
    a real array of twice the width (the reference's cuFFT layout)."""
    z = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([z.real, z.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@register("ifft", params_spec=(Param("compute_size", int, 128),),
          hint="ifft")
def _ifft(p, c, data):
    """The inverse, unnormalised as cuFFT's (scaled by the width)."""
    d = data.shape[-1] // 2
    z = data.reshape(data.shape[:-1] + (d, 2)).float()
    comp = torch.complex(z[..., 0], z[..., 1])
    return (torch.fft.ifft(comp, dim=-1).real * d).to(data.dtype)


def _fft_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return [tuple(d)], [tuple(d[:-1]) + (2 * d[-1],)], []


def _ifft_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return [tuple(d)], [tuple(d[:-1]) + (d[-1] // 2,)], []


_REGISTRY["fft"].infer_shape = _fft_infer_shape
_REGISTRY["ifft"].infer_shape = _ifft_infer_shape
alias("_contrib_fft", "fft")
alias("_contrib_ifft", "ifft")
