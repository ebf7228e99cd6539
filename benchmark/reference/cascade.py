"""Plain reference of the face cascade: detect -> face ROI -> mesh -> eye
ROIs -> both irises -> refined mesh, in float32 with TF32 off.

A frozen copy of the program's plain path (the MediaPipe stage semantics
its docstrings cite: face_detection.rs, face_landmark.rs,
iris_landmark.rs, nms.rs, transform.rs), with the nets run op by op by
``tflite.PlainNet``, every ROI warp a plain zero-border bilinear gather
and every ROI worked out again from this reference's own detections.
It imports nothing of the program: it reads the same ``.npz`` weights
(the configuration's ``graphs``) and is handed the same frames.

``run(config, batches, root)`` returns every field of the cascade's
result for each batch as numpy arrays with a face axis ([B, K, ...]),
computed in blocks of frames so that it fits beside the frame pool.
"""

import math
from pathlib import Path

import numpy as np
import torch

from .tflite import Graph, PlainNet

MIN_SCORE = 0.5                  # face_detection.rs:136
NMS_THRESHOLD = 0.3              # face_detection.rs:139
RAW_SCORE_LIMIT = 80.0           # face_detection.rs:133
MESH_ROI_SCALE = (1.5, 1.5)      # face_landmark.rs:30
IRIS_ROI_SCALE = (2.3, 2.3)      # iris_landmark.rs:27
LEFT_EYE = (33, 133)             # iris_landmark.rs:29-35
RIGHT_EYE = (362, 263)

# SSD anchor options (face_detection.rs:28-86): layers, input h and w,
# strides, interpolated scale aspect ratio
SSD = {"BACK_CAMERA": (4, 256, 256, (16, 32, 32, 32), 1.0),
       "FULL_SPARSE": (1, 192, 192, (4, 0, 0, 0), 0.0)}

# iris contour index -> face mesh index (iris_landmark.rs:64-95)
LEFT_EYE_TO_MESH = [
    33, 7, 163, 144, 145, 153, 154, 155, 133, 246, 161, 160, 159, 158, 157,
    173, 130, 25, 110, 24, 23, 22, 26, 112, 243, 247, 30, 29, 27, 28, 56,
    190, 226, 31, 228, 229, 230, 231, 232, 233, 244, 113, 225, 224, 223,
    222, 221, 189, 35, 124, 46, 53, 52, 65, 143, 111, 117, 118, 119, 120,
    121, 128, 245, 156, 70, 63, 105, 66, 107, 55, 193]
RIGHT_EYE_TO_MESH = [
    263, 249, 390, 373, 374, 380, 381, 382, 362, 466, 388, 387, 386, 385,
    384, 398, 359, 255, 339, 254, 253, 252, 256, 341, 463, 467, 260, 259,
    257, 258, 286, 414, 446, 261, 448, 449, 450, 451, 452, 453, 464, 342,
    445, 444, 443, 442, 441, 413, 265, 353, 276, 283, 282, 295, 372, 340,
    346, 347, 348, 349, 350, 357, 465, 383, 300, 293, 334, 296, 336, 285,
    417]

FIELDS = ("detection", "score", "face_valid", "face_roi", "mesh", "mesh_raw",
          "mesh_score", "mesh_valid", "eye_rois", "iris")


def anchors(opts):
    """SSD anchors [N, 2] (face_detection.rs:366-413)."""
    layers, in_h, in_w, strides, aspect = opts
    out = []
    layer = 0
    while layer < layers:
        last, repeats = layer, 0
        while last < layers and strides[last] == strides[layer]:
            last += 1
            repeats += 2 if aspect == 1.0 else 1
        fm_h, fm_w = in_h // strides[layer], in_w // strides[layer]
        for y in range(fm_h):
            for x in range(fm_w):
                out.extend([((x + 0.5) / fm_w, (y + 0.5) / fm_h)] * repeats)
        layer = last
    return np.asarray(out, np.float32)


# ---- warps (transform.rs:188-309) ----------------------------------------


def letterbox_padding(roi_w, roi_h, out_size):
    out_aspect = float(out_size[1] // out_size[0])
    roi_aspect = roi_h / roi_w
    w_i, h_i = torch.trunc(roi_w), torch.trunc(roi_h)
    cond = out_aspect > roi_aspect
    pad_y = torch.where(cond, (1.0 - roi_aspect / out_aspect) / 2.0, 0.0)
    pad_x = torch.where(cond, 0.0, (1.0 - out_aspect / roi_aspect) / 2.0)
    new_h = torch.where(cond, torch.trunc(roi_w * out_aspect), h_i)
    new_w = torch.where(cond, w_i, torch.trunc(roi_h / out_aspect))
    changed = (new_w != w_i) | (new_h != h_i)
    pv_exact = (new_h - (new_h * roi_h) / (roi_w * out_aspect)) / 2.0
    ph_exact = (new_w - (new_w * out_aspect * roi_w) / roi_h) / 2.0
    ph = torch.where(changed & ~cond, torch.trunc(ph_exact), 0.0)
    pv = torch.where(changed & cond, torch.trunc(pv_exact), 0.0)
    return pad_x, pad_y, ph, pv


def source_coords(roi, out_size, keep_aspect, flip):
    """Source pixel coordinates [..., Ho, Wo] of the warp of ABS ROIs
    [..., 5] to ``out_size`` (w, h), and the letterbox padding [..., 4]."""
    wo, ho = out_size
    dev = roi.device
    cx, cy, rw, rh, rot = (roi[..., k] for k in range(5))

    def pf(v):
        return v[..., None, None]

    u = torch.arange(wo, dtype=torch.float32, device=dev)[None, :].expand(
        ho, wo)
    v = torch.arange(ho, dtype=torch.float32, device=dev)[:, None].expand(
        ho, wo)
    if flip:
        u = (wo - 1) - u
    if keep_aspect:
        pad_x, pad_y, ph, pv = letterbox_padding(rw, rh, out_size)
        w_i, h_i = torch.trunc(rw), torch.trunc(rh)
        qx = ((u + 0.5) * pf(w_i + 2.0 * ph) / wo - 0.5 - pf(ph)) / pf(w_i)
        qy = ((v + 0.5) * pf(h_i + 2.0 * pv) / ho - 0.5 - pf(pv)) / pf(h_i)
        padding = torch.stack([pad_x, pad_y, pad_x, pad_y], dim=-1)
    else:
        qx, qy = u / wo, v / ho
        padding = torch.zeros(roi.shape[:-1] + (4,), dtype=torch.float32,
                              device=dev)
    s, c = torch.sin(rot), torch.cos(rot)
    hw, hh = rw / 2.0, rh / 2.0
    c0x, c0y = cx + (-hw) * c - (-hh) * s, cy + (-hw) * s + (-hh) * c
    c1x, c1y = cx + hw * c - (-hh) * s, cy + hw * s + (-hh) * c
    c3x, c3y = cx + (-hw) * c - hh * s, cy + (-hw) * s + hh * c
    src_x = pf(c0x) + qx * pf(c1x - c0x) + qy * pf(c3x - c0x)
    src_y = pf(c0y) + qx * pf(c1y - c0y) + qy * pf(c3y - c0y)
    return src_x, src_y, padding


def normalize(out, lo, hi):
    """Round to the uint8 level the reference chain stores, then map
    0..255 to (lo, hi)."""
    return torch.round(out) * ((hi - lo) / 255.0) + lo


def gather_warp(planes, xs, ys):
    """Zero-border bilinear samples [B, ..., Ho, Wo, 3] of f32 planes
    [B, 3, H, W] at xs/ys [B, ..., Ho, Wo]."""
    b, c, h, w = planes.shape
    shape = xs.shape
    xs, ys = xs.reshape(b, -1), ys.reshape(b, -1)
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    dx, dy = (xs - x0f)[:, None], (ys - y0f)[:, None]
    x0, y0 = x0f.long(), y0f.long()
    flat = planes.reshape(b, c, h * w)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 2, lin[:, None].expand(b, c, -1))
        return torch.where(ok[:, None], vals, 0.0)

    top = tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx
    bot = tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx
    out = top * (1 - dy) + bot * dy                       # [B, 3, P]
    return out.movedim(1, -1).reshape(*shape, c)


def whole_frame_warp(planes, size, det_size):
    """The detector's input: the whole frame letterboxed to ``det_size``
    by two hat-weight matmuls (the warp of a rotation-0 ROI is separable),
    and the padding."""
    w, h = size
    out_aspect = float(det_size[1] // det_size[0])
    if out_aspect > h / w:
        new_w, new_h, pv, ph = w, int(w * out_aspect), int(
            (1.0 - (h / w) / out_aspect) / 2.0 * int(w * out_aspect)), 0
    else:
        new_w, new_h = int(h / out_aspect), h
        ph, pv = int((1.0 - out_aspect / (h / w)) / 2.0 * new_w), 0
    if (w + 2 * ph, h + 2 * pv) != (new_w, new_h):
        raise NotImplementedError(
            f"frame size {size}: the letterbox's first resize is not the "
            f"identity (the two-stage letterbox is not part of this "
            f"reference)")
    roi = torch.tensor([0.5 * w, 0.5 * h, w, h, 0.0], dtype=torch.float32,
                       device=planes.device)
    sx, sy, padding = source_coords(roi, det_size, True, False)
    taps_w = torch.arange(w, dtype=torch.float32, device=planes.device)
    taps_h = torch.arange(h, dtype=torch.float32, device=planes.device)
    wx = torch.clamp(1.0 - torch.abs(taps_w - sx[0, :, None]), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(taps_h - sy[:, 0, None]), min=0.0)
    out = torch.matmul(torch.matmul(wy, planes), wx.transpose(-1, -2))
    return normalize(out.movedim(-3, -1), -1.0, 1.0), padding


# ---- detection post-processing (face_detection.rs, nms.rs) ---------------


def decode(raw, anchor, scale):
    pts = raw.reshape(*raw.shape[:-1], -1, 2) / scale
    shift = (torch.arange(pts.shape[-2], device=raw.device) != 1).float()
    pts = pts + shift[None, :, None] * anchor[:, None, :]
    center, half = pts[..., 0, :], pts[..., 1, :] / 2.0
    return torch.cat([(center - half)[..., None, :],
                      (center + half)[..., None, :], pts[..., 2:, :]], -2)


def _merge(data, scores, area, alive, top):
    top_box = torch.gather(data, -3, top[..., None, None].expand(
        *top.shape, *data.shape[-2:])).squeeze(-3)
    ixmin = torch.maximum(data[..., 0, 0], top_box[..., 0, 0, None])
    iymin = torch.maximum(data[..., 0, 1], top_box[..., 0, 1, None])
    ixmax = torch.minimum(data[..., 1, 0], top_box[..., 1, 0, None])
    iymax = torch.minimum(data[..., 1, 1], top_box[..., 1, 1, None])
    iw, ih = ixmax - ixmin, iymax - iymin
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = area + torch.gather(area, -1, top) - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    cand = alive & (iou > NMS_THRESHOLD)
    wgt = torch.where(cand, scores, 0.0)
    merged = (torch.einsum("...n,...npk->...pk", wgt, data)
              / torch.clamp(wgt.sum(-1), min=1e-12)[..., None, None])
    return torch.where(cand.any(-1)[..., None, None], merged, top_box), cand


def weighted_nms(data, scores, valid, k):
    """MediaPipe weighted NMS to ``k`` faces (nms.rs:56-124): one merge
    for k = 1, else the sequential loop over the full pool."""
    w_ = data[..., 1, 0] - data[..., 0, 0]
    h_ = data[..., 1, 1] - data[..., 0, 1]
    area = torch.where((w_ > 0) & (h_ > 0), w_ * h_, 0.0)
    if k == 1:
        top = torch.argmax(torch.where(valid, scores, -1e30), -1,
                           keepdim=True)
        out, _ = _merge(data, scores, area, valid, top)
        return (out[..., None, :, :], torch.gather(scores, -1, top),
                torch.gather(valid, -1, top))
    idx = torch.arange(scores.shape[-1], device=scores.device)
    alive = valid
    stopped = torch.zeros(valid.shape[:-1], dtype=torch.bool,
                          device=valid.device)
    outs_d, outs_s, outs_v = [], [], []
    for _ in range(k):
        any_alive = alive.any(-1)
        top = torch.argmax(torch.where(alive, scores, -1e30), -1,
                           keepdim=True)
        out, cand = _merge(data, scores, area, alive, top)
        outs_d.append(out)
        outs_s.append(torch.gather(scores, -1, top)[..., 0])
        outs_v.append(any_alive & ~stopped)
        alive = alive & ~cand & (idx != top)
        stopped = stopped | ~cand.any(-1)
    return (torch.stack(outs_d, -3), torch.stack(outs_s, -1),
            torch.stack(outs_v, -1))


def unletterbox(data, padding):
    left, top, right, bottom = (padding[..., i, None] for i in range(4))
    return torch.stack([(data[..., 0] - left) / (1.0 - (left + right)),
                        (data[..., 1] - top) / (1.0 - (top + bottom))], -1)


def project(raw, tensor_size, size, padding, roi, flip=False):
    """Tensor-space landmarks [..., L*3] -> normalized image space
    [..., L, 3] (transform.rs:351-432)."""
    wt, ht = tensor_size
    pts = raw.reshape(*raw.shape[:-1], -1, 3)
    x, y, z = pts[..., 0] / wt, pts[..., 1] / ht, pts[..., 2] / wt
    if flip:
        x = 1.0 - x
    left, top, right, bottom = (padding[..., i, None] for i in range(4))
    hs, vs = 1.0 - (left + right), 1.0 - (top + bottom)
    x, y, z = (x - left) / hs, (y - top) / vs, z / hs
    w, h = size
    s, c = torch.sin(roi[..., 4, None]), torch.cos(roi[..., 4, None])
    xc, yc = x - 0.5, y - 0.5
    nw, nh = roi[..., 2, None] / w, roi[..., 3, None] / h
    return torch.stack([(xc * c - yc * s) * nw + roi[..., 0, None] / w,
                        (xc * s + yc * c) * nh + roi[..., 1, None] / h,
                        z * nw], -1)


def _norm_rotation(a):
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def bbox_roi(xmin, ymin, xmax, ymax, kp0, kp1, scale, size):
    """Square-long ROI [..., 5] (ABS) of a normalized box, rotated by the
    keypoint pair (transform.rs:62-109)."""
    w, h = size
    long_side = torch.maximum((xmax - xmin) * w, (ymax - ymin) * h)
    rot = _norm_rotation(-torch.atan2(kp0[..., 1] - kp1[..., 1],
                                      kp1[..., 0] - kp0[..., 0]))
    return torch.stack([(xmin + xmax) / 2.0 * w, (ymin + ymax) / 2.0 * h,
                        long_side * scale[0], long_side * scale[1], rot], -1)


def to_norm(roi, size):
    w, h = size
    return torch.stack([roi[..., 0] / w, roi[..., 1] / h, roi[..., 2] / w,
                        roi[..., 3] / h, roi[..., 4]], -1)


class Cascade:
    """The reference cascade of one configuration on ``device``."""

    def __init__(self, config, root, device):
        data = Path(root) / "tpu_face" / "data"
        self.k = int(config["max_faces"])
        self.nets = {}
        for name, file in config["graphs"].items():
            g = Graph(data / file)
            self.nets[name] = (PlainNet(g, device), g.input_shape[1:3])
        self.anchors = torch.from_numpy(
            anchors(SSD[config["detector"]])).to(device)
        self.left = torch.tensor(LEFT_EYE_TO_MESH, device=device)
        self.right = torch.tensor(RIGHT_EYE_TO_MESH, device=device)

    def __call__(self, frames):
        """Every result field [B, K, ...] of uint8 frames [B, H, W, 3]."""
        b, h, w, _ = frames.shape
        size = (w, h)
        planes = frames.permute(0, 3, 1, 2).float().contiguous()
        net, (dh, dw) = self.nets["detector"]
        tensor, padding = whole_frame_warp(planes, size, (dw, dh))
        raw_boxes, raw_scores = net(tensor)
        boxes = decode(raw_boxes, self.anchors, float(dh))
        scores = torch.sigmoid(torch.clamp(raw_scores.reshape(b, -1),
                                           -RAW_SCORE_LIMIT, RAW_SCORE_LIMIT))
        valid = (scores > MIN_SCORE) & torch.all(
            boxes[..., 1, :] > boxes[..., 0, :], dim=-1)
        det, score, face_valid = weighted_nms(boxes, scores, valid, self.k)
        det = unletterbox(det, padding)

        def px(p):
            return torch.stack([p[..., 0] * w, p[..., 1] * h], -1)

        face_roi = bbox_roi(det[..., 0, 0], det[..., 0, 1], det[..., 1, 0],
                            det[..., 1, 1], px(det[..., 2, :]),
                            px(det[..., 3, :]), MESH_ROI_SCALE, size)
        net, (mh, mw) = self.nets["mesh"]
        mx, my, mpad = source_coords(face_roi, (mw, mh), False, False)
        crops = normalize(gather_warp(planes, mx, my), 0.0, 1.0)
        raw_mesh, raw_flag = net(crops.flatten(0, 1))
        mesh_score = torch.sigmoid(raw_flag.reshape(b, self.k))
        mesh = project(raw_mesh.reshape(b, self.k, -1), (mw, mh), size, mpad,
                       face_roi)

        def eye_roi(i0, i1):
            p0, p1 = mesh[..., i0, :], mesh[..., i1, :]
            return bbox_roi(torch.minimum(p0[..., 0], p1[..., 0]),
                            torch.minimum(p0[..., 1], p1[..., 1]),
                            torch.maximum(p0[..., 0], p1[..., 0]),
                            torch.maximum(p0[..., 1], p1[..., 1]),
                            p0[..., :2], p1[..., :2], IRIS_ROI_SCALE, size)

        lroi, rroi = eye_roi(*LEFT_EYE), eye_roi(*RIGHT_EYE)
        net, (ih, iw) = self.nets["iris"]
        lx, ly, lp = source_coords(lroi, (iw, ih), True, False)
        rx, ry, rp = source_coords(rroi, (iw, ih), True, True)
        left = normalize(gather_warp(planes, lx, ly), 0.0, 1.0)
        right = normalize(gather_warp(planes, rx, ry), 0.0, 1.0)
        pair = torch.stack([left, right], 2)          # [B, K, 2, H, W, 3]
        raw_contour, raw_iris = net(pair.flatten(0, 2))
        raw_contour = raw_contour.reshape(b, self.k, 2, -1)
        raw_iris = raw_iris.reshape(b, self.k, 2, -1)
        l_contour = project(raw_contour[:, :, 0], (iw, ih), size, lp, lroi)
        r_contour = project(raw_contour[:, :, 1], (iw, ih), size, rp, rroi,
                            True)
        l_iris = project(raw_iris[:, :, 0], (iw, ih), size, lp, lroi)
        r_iris = project(raw_iris[:, :, 1], (iw, ih), size, rp, rroi, True)
        refined = mesh.index_copy(2, self.left, l_contour)
        refined = refined.index_copy(2, self.right, r_contour)
        return {"detection": det, "score": score, "face_valid": face_valid,
                "face_roi": to_norm(face_roi, size), "mesh": refined,
                "mesh_raw": mesh, "mesh_score": mesh_score,
                "mesh_valid": face_valid & (mesh_score > 0.5),
                "eye_rois": to_norm(torch.stack([lroi, rroi], -2), size),
                "iris": torch.stack([l_iris, r_iris], -3)}


def run(config, batches, root, block=32):
    """The reference's results for batches of uint8 frames [B, H, W, 3]
    (on the device it runs on), one {field: numpy array [B, K, ...]} per
    batch, ``block`` frames at a time, with TF32 off."""
    cascade = Cascade(config, root, batches[0].device)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    results = []
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            for frames in batches:
                parts = {f: [] for f in FIELDS}
                for i in range(0, frames.shape[0], block):
                    out = cascade(frames[i:i + block])
                    for f in FIELDS:
                        parts[f].append(out[f].cpu().numpy())
                results.append({f: np.concatenate(v)
                                for f, v in parts.items()})
    finally:
        matmul.allow_tf32 = saved
    return results
