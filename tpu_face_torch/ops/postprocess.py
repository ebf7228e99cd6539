"""Detection post-processing on tensors (counterpart of
tpu_face/ops/postprocess.py).

* ``decode_boxes``        — reference face_detection.rs:269-296
* ``clamped_sigmoid``     — reference face_detection.rs:300-314 (±80 clamp)
* ``weighted_nms``        — reference nms.rs:56-124 (one face per frame,
  or the full-pool sequential merge for K faces)
* ``plain_nms``           — reference nms.rs:19-53
* ``letterbox_removal``   — reference transform.rs:115-142
* ``project_landmarks``   — reference transform.rs:351-432

Every function takes an optional leading batch: candidate tensors
``[..., N, ...]``, per-frame padding ``[..., 4]`` and ROIs ``[..., 5]``.
"""

from typing import Optional, Tuple

import torch

RAW_SCORE_LIMIT = 80.0  # face_detection.rs:133
MIN_SCORE = 0.5  # face_detection.rs:136
MIN_SUPPRESSION_THRESHOLD = 0.3  # face_detection.rs:139


def decode_boxes(raw_boxes, anchors, scale: float):
    """raw [..., N, 2*P] -> [..., N, P, 2] decoded points.

    Point rows: 0 = box center -> top-left corner, 1 = box size ->
    bottom-right corner, 2.. = keypoints.  Every row except 1 is
    anchor-shifted."""
    pts = raw_boxes.reshape(*raw_boxes.shape[:-1], -1, 2) / scale
    num_points = pts.shape[-2]
    # made on the device (no host value is copied in: a CUDA graph can
    # capture the call)
    shift = (torch.arange(num_points, device=raw_boxes.device) != 1).to(
        torch.float32)
    pts = pts + shift[None, :, None] * anchors[:, None, :]
    center = pts[..., 0, :]
    half = pts[..., 1, :] / 2.0
    return torch.cat([(center - half)[..., None, :],
                      (center + half)[..., None, :], pts[..., 2:, :]],
                     dim=-2)


def clamped_sigmoid(raw_scores):
    return torch.sigmoid(torch.clamp(raw_scores, -RAW_SCORE_LIMIT,
                                     RAW_SCORE_LIMIT))


def detection_validity(boxes, scores, min_score: float = MIN_SCORE):
    """score > threshold AND strictly positive box extent
    (reference face_detection.rs:317-323,326)."""
    ok_box = torch.all(boxes[..., 1, :] > boxes[..., 0, :], dim=-1)
    return (scores > min_score) & ok_box


def weighted_nms(data, scores, valid, max_outputs: int,
                 threshold: float = MIN_SUPPRESSION_THRESHOLD):
    """MediaPipe weighted NMS (reference nms.rs:56-124).

    data [..., N, P, 2], scores/valid [..., N].  Returns (out_data
    [..., T, P, 2], out_scores [..., T], out_valid [..., T]) with
    T = max_outputs.

    Repeatedly take the highest-scoring remaining detection, gather every
    remaining detection with IoU > threshold (the top one always matches
    itself), emit their score-weighted average with the top score, and
    remove the merged set; the reference's loop guard (stop when nothing
    was removed, only reachable with zero-area boxes) is a sticky
    ``stopped`` flag.  Like the JAX version, ``max_outputs == 1`` takes
    the single-merge path and more outputs the full-pool loop (the two
    differ by about 1e-5 in JAX, from its reduction orders)."""
    if max_outputs < 1:
        raise ValueError(f"max_outputs must be >= 1, got {max_outputs}")
    if max_outputs == 1:
        return _weighted_nms_top1(data, scores, valid, threshold)
    return _weighted_nms_pool(data, scores, valid, max_outputs, threshold)


def _areas(data):
    xmin, ymin = data[..., 0, 0], data[..., 0, 1]
    xmax, ymax = data[..., 1, 0], data[..., 1, 1]
    w_ = xmax - xmin
    h_ = ymax - ymin
    return torch.where((w_ > 0) & (h_ > 0), w_ * h_, 0.0)


def _merge_top(data, scores, area, alive, top, threshold):
    """One merge of the sequential algorithm: the IoU row of the top
    detection ``top`` [..., 1] against every candidate, the candidates
    ``alive`` that overlap it, and their weighted average.  Returns
    (the average, or the top row where no candidate overlaps, [..., P, 2];
    cand [..., N])."""
    top_box = torch.gather(
        data, -3, top[..., None, None].expand(*top.shape, *data.shape[-2:])
    ).squeeze(-3)                                               # [..., P, 2]
    xmin, ymin = data[..., 0, 0], data[..., 0, 1]
    xmax, ymax = data[..., 1, 0], data[..., 1, 1]
    ixmin = torch.maximum(xmin, top_box[..., 0, 0, None])
    iymin = torch.maximum(ymin, top_box[..., 0, 1, None])
    ixmax = torch.minimum(xmax, top_box[..., 1, 0, None])
    iymax = torch.minimum(ymax, top_box[..., 1, 1, None])
    iw = ixmax - ixmin
    ih = iymax - iymin
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = area + torch.gather(area, -1, top) - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    cand = alive & (iou > threshold)
    w = torch.where(cand, scores, 0.0)
    merged = (torch.einsum("...n,...npk->...pk", w, data)
              / torch.clamp(w.sum(-1), min=1e-12)[..., None, None])
    out_d = torch.where(cand.any(-1)[..., None, None], merged, top_box)
    return out_d, cand


def _weighted_nms_top1(data, scores, valid, threshold):
    """Single-output weighted NMS: the first merge of the sequential
    algorithm — top detection by argmax (first max wins ties, as the
    reference's stable sort does), one IoU row, one weighted average."""
    masked = torch.where(valid, scores, -1e30)
    top = torch.argmax(masked, dim=-1, keepdim=True)           # [..., 1]
    out_d, _ = _merge_top(data, scores, _areas(data), valid, top,
                          threshold)
    return (out_d[..., None, :, :], torch.gather(scores, -1, top),
            torch.gather(valid, -1, top))


def _weighted_nms_pool(data, scores, valid, max_outputs, threshold):
    """The full-pool loop (tpu_face/ops/postprocess.py's scan): each of
    ``max_outputs`` iterations argmaxes the alive scores (first index
    among equals), merges, and retires the merged set and the top.  An
    output is valid while anything was alive and no earlier merge came
    up empty."""
    area = _areas(data)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    alive = valid
    stopped = torch.zeros(valid.shape[:-1], dtype=torch.bool,
                          device=valid.device)
    outs_d, outs_s, outs_v = [], [], []
    for _ in range(max_outputs):
        any_alive = alive.any(-1)
        top = torch.argmax(torch.where(alive, scores, -1e30), dim=-1,
                           keepdim=True)                       # [..., 1]
        out_d, cand = _merge_top(data, scores, area, alive, top, threshold)
        outs_d.append(out_d)
        outs_s.append(torch.gather(scores, -1, top)[..., 0])
        outs_v.append(any_alive & ~stopped)
        alive = alive & ~cand & (idx != top)
        stopped = stopped | ~cand.any(-1)
    return (torch.stack(outs_d, -3), torch.stack(outs_s, -1),
            torch.stack(outs_v, -1))


def _iou_matrix(boxes):
    """Pairwise IoU of corner-format boxes [..., M, 4] -> [..., M, M]
    (reference nms.rs:5-17: an empty intersection or a non-positive
    union gives 0)."""
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    ixmin = torch.maximum(xmin[..., :, None], xmin[..., None, :])
    iymin = torch.maximum(ymin[..., :, None], ymin[..., None, :])
    ixmax = torch.minimum(xmax[..., :, None], xmax[..., None, :])
    iymax = torch.minimum(ymax[..., :, None], ymax[..., None, :])
    iw = ixmax - ixmin
    ih = iymax - iymin
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    w = xmax - xmin
    h = ymax - ymin
    area = torch.where((w > 0) & (h > 0), w * h, 0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def plain_nms(data, scores, valid, max_outputs: int,
              threshold: float = MIN_SUPPRESSION_THRESHOLD,
              top_m: int = 128):
    """Greedy (non-weighted) NMS, reference nms.rs:19-53.

    data [..., N, P, 2], scores/valid [..., N].  The ``top_m`` best valid
    candidates by score (a stable sort: the first index wins ties, as
    the JAX version's ``top_k``) are visited in order; each is kept
    unless it overlaps (IoU > threshold) one already kept.  Returns the
    kept rows first, in score order, then the others: (data
    [..., T, P, 2], scores [..., T], keep [..., T]) with T =
    min(max_outputs, top_m, N)."""
    masked = torch.where(valid, scores, -1e30)
    order = torch.sort(masked, dim=-1, descending=True,
                       stable=True).indices[..., :top_m]
    d = torch.gather(data, -3, order[..., None, None].expand(
        *order.shape, *data.shape[-2:]))
    sc = torch.gather(scores, -1, order)
    v = torch.gather(valid, -1, order)
    iou = _iou_matrix(torch.stack([d[..., 0, 0], d[..., 0, 1],
                                   d[..., 1, 0], d[..., 1, 1]], dim=-1))
    keep = torch.zeros_like(v)
    for i in range(v.shape[-1]):
        suppressed = (keep & (iou[..., i, :] > threshold)).any(-1)
        keep[..., i] = v[..., i] & ~suppressed
    # compact the kept rows to the front (stable), fixed size
    front = torch.sort((~keep).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :max_outputs]
    return (torch.gather(d, -3, front[..., None, None].expand(
                *front.shape, *d.shape[-2:])),
            torch.gather(sc, -1, front), torch.gather(keep, -1, front))


def letterbox_removal(data, padding):
    """Undo letterboxing on detection rows [..., P, 2]; padding
    [..., 4] with the leading dims of ``data`` minus (P, 2), or (4,)."""
    left, top, right, bottom = (padding[..., k, None] for k in range(4))
    h_scale = 1.0 - (left + right)
    v_scale = 1.0 - (top + bottom)
    x = (data[..., 0] - left) / h_scale
    y = (data[..., 1] - top) / v_scale
    return torch.stack([x, y], dim=-1)


def project_landmarks(raw, tensor_size: Tuple[int, int],
                      image_size: Tuple[int, int], padding,
                      roi_abs: Optional[torch.Tensor],
                      flip_horizontal=False):
    """Tensor-space landmarks [..., L*3] -> normalized image-space
    [..., L, 3] (reference transform.rs:351-432, with the MediaPipe
    z-convention: z divided by tensor width and scaled by roi width).
    padding [..., 4]; roi_abs [..., 5]; flip_horizontal a bool or a
    bool tensor [...]."""
    wt, ht = tensor_size
    pts = raw.reshape(*raw.shape[:-1], -1, 3)
    x = pts[..., 0] / wt
    y = pts[..., 1] / ht
    z = pts[..., 2] / wt
    if isinstance(flip_horizontal, torch.Tensor):
        x = torch.where(flip_horizontal[..., None], 1.0 - x, x)
    elif flip_horizontal:
        x = 1.0 - x

    left, top, right, bottom = (padding[..., k, None] for k in range(4))
    h_scale = 1.0 - (left + right)
    v_scale = 1.0 - (top + bottom)
    x = (x - left) / h_scale
    y = (y - top) / v_scale
    z = z / h_scale

    if roi_abs is not None:
        w, h = image_size
        ncx, ncy = roi_abs[..., 0, None] / w, roi_abs[..., 1, None] / h
        nw, nh = roi_abs[..., 2, None] / w, roi_abs[..., 3, None] / h
        rot = roi_abs[..., 4, None]
        s, c = torch.sin(rot), torch.cos(rot)
        xc = x - 0.5
        yc = y - 0.5
        rx = xc * c - yc * s
        ry = xc * s + yc * c
        x = rx * nw + ncx
        y = ry * nh + ncy
        z = z * nw
    return torch.stack([x, y, z], dim=-1)
