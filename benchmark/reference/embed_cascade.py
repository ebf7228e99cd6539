"""Plain reference of the identification cascade: detect -> crop ->
IR-ResNet -> L2 norm, in float32 with TF32 off.

Detection and its weighted NMS are ``reference.cascade``'s functions on
the detector run op by op by ``tflite.PlainNet``.  Each face's crop is the
int-truncated box of its detection intersected with the frame
(face_embeddings.rs:101-109; the intersection keeps a box at the frame's
edge inside it), resampled to the net's 112x112 at the direct warp's
coordinates, rounded to uint8 levels and mapped to (0, 1); the net is
``reference.iresnet``'s forward from the weights under insightface's
names, in blocks of 32 crops.  It imports nothing of the program.

The net's blocks are a quarter of the program's 128 crops a call, so
cuDNN runs the reference's convolutions at other shapes than the
program's and may pick other algorithms for them: the comparison holds
the program to float32's accuracy, not to one algorithm's rounding.  On
an H100 the f32 net's unit-norm embeddings at 32, 64 or 128 crops a call
lie within 5e-7 of the reference's in blocks of 32, 48 or 128 alike;
TF32 in the net's convolutions moves them by 1.4e-4 to 1.6e-4.

The crop's bilinear samples are two hat-weight matmuls (the crop does
not rotate, so it is separable), as ``reference.cascade`` samples the
detector's whole-frame warp, and not a gather: a gather sums the same
two taps in another order, so at a sample that lies on a half uint8
level it rounds the other way now and then (about 100 of 4.8 M values a
call of 128 crops, one level each), and those flips alone move a
unit-norm embedding of R100 by up to 5e-5, a third of what TF32 in the
net moves it (on an H100): the comparison could not tell the two apart.

Departures from insightface's own pipeline, shared with the program:
the crop is the detection's axis-aligned box, not ArcFace's 5-point
similarity alignment; the input map to (-1, 1) is applied to that crop;
dropout is the identity.

``run(config, batches, root)`` returns, for each batch, the fields of
``EmbedResult`` with a face axis ([B, K, ...]) as numpy arrays: the
detection, score, validity, crop box (x0, y0, x1, y1 in pixels) and the
L2-normalized embedding.
"""

from pathlib import Path

import numpy as np
import torch

from models import iresnet as generator

from . import iresnet
from .cascade import (MIN_SCORE, RAW_SCORE_LIMIT, SSD, anchors, decode,
                      normalize, source_coords, unletterbox, weighted_nms,
                      whole_frame_warp)
from .tflite import Graph, PlainNet

FIELDS = ("detection", "score", "face_valid", "crop_bbox", "embedding")
# crops a block of the net: not the program's 128 a call
NET_BLOCK = 32


def crop_boxes(det, size):
    """Int-truncated crop boxes [..., 4] (x0, y0, x1, y1) in pixels of
    normalized detections [..., 8, 2], intersected with the frame (at
    least one pixel each way)."""
    w, h = size
    x = torch.trunc(det[..., 0, 0] * w)
    y = torch.trunc(det[..., 0, 1] * h)
    cw = torch.trunc((det[..., 1, 0] - det[..., 0, 0]) * w)
    ch = torch.trunc((det[..., 1, 1] - det[..., 0, 1]) * h)
    x0, y0 = x.clamp(0.0, w - 1.0), y.clamp(0.0, h - 1.0)
    x1 = torch.maximum(x + cw, x0 + 1.0).clamp(max=float(w))
    y1 = torch.maximum(y + ch, y0 + 1.0).clamp(max=float(h))
    return torch.stack([x0, y0, x1, y1], -1)


class EmbedCascade:
    """The reference identification cascade of one configuration."""

    def __init__(self, config, root, device, weights):
        data = Path(root) / "tpu_face" / "data"
        self.k = int(config["max_faces"])
        g = Graph(data / config["graphs"]["detector"])
        self.detector = PlainNet(g, device)
        self.dh, self.dw = g.input_shape[1:3]
        self.anchors = torch.from_numpy(
            anchors(SSD[config["detector"]])).to(device)
        self.weights = iresnet.load(weights, device)
        self.side = int(config["widths"]["input"][0])

    def detect(self, frames):
        """(planes, detections [B, K, 8, 2], scores, validity) of uint8
        frames [B, H, W, 3]."""
        b, h, w, _ = frames.shape
        planes = frames.permute(0, 3, 1, 2).float().contiguous()
        tensor, padding = whole_frame_warp(planes, (w, h), (self.dw, self.dh))
        raw_boxes, raw_scores = self.detector(tensor)
        boxes = decode(raw_boxes, self.anchors, float(self.dh))
        scores = torch.sigmoid(torch.clamp(raw_scores.reshape(b, -1),
                                           -RAW_SCORE_LIMIT, RAW_SCORE_LIMIT))
        valid = (scores > MIN_SCORE) & torch.all(
            boxes[..., 1, :] > boxes[..., 0, :], dim=-1)
        det, score, face_valid = weighted_nms(boxes, scores, valid, self.k)
        return planes, unletterbox(det, padding), score, face_valid

    def crops(self, planes, boxes):
        """Crops [B, K, 3, S, S] in (0, 1) of crop boxes [B, K, 4] over
        f32 planes [B, 3, H, W]: per channel ``wy @ P @ wx^T`` with the
        zero-border bilinear hat weights max(0, 1 - |tap - s|)."""
        x0, y0, x1, y1 = boxes.unbind(-1)
        roi = torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0,
                           y1 - y0, torch.zeros_like(x0)], -1)
        xs, ys, _ = source_coords(roi, (self.side, self.side), False, False)
        h, w = planes.shape[-2:]

        def hat(s, n):
            taps = torch.arange(n, dtype=torch.float32, device=s.device)
            return torch.clamp(1.0 - torch.abs(taps - s[..., None]), min=0.0)

        wx = hat(xs[..., 0, :], w)                    # [B, K, S, W]
        wy = hat(ys[..., :, 0], h)                    # [B, K, S, H]
        out = torch.matmul(torch.matmul(wy[:, :, None], planes[:, None]),
                           wx[:, :, None].transpose(-1, -2))
        return normalize(out, 0.0, 1.0)

    def __call__(self, frames):
        """Every result field [B, K, ...] of uint8 frames [B, H, W, 3]."""
        b, h, w, _ = frames.shape
        planes, det, score, face_valid = self.detect(frames)
        boxes = crop_boxes(det, (w, h))
        crops = self.crops(planes, boxes)
        emb = iresnet.embed(self.weights, crops.flatten(0, 1), NET_BLOCK)
        return {"detection": det, "score": score, "face_valid": face_valid,
                "crop_bbox": boxes, "embedding": emb.reshape(b, self.k, -1)}


def run(config, batches, root, block=32):
    """The reference's results for batches of uint8 frames [B, H, W, 3]
    (on the device it runs on), one {field: numpy array [B, K, ...]} per
    batch, ``block`` frames at a time, with TF32 off.  The net's weights
    are the configuration's seeded ones (``models/iresnet.py``) under
    insightface's names, written beside the program's graph where they
    are not there yet."""
    weights = generator.model_dir(config, root) / generator.WEIGHTS_FILE
    if not weights.exists():
        generator.write_config(config, root, files=(generator.WEIGHTS_FILE,))
    cascade = EmbedCascade(config, root, batches[0].device, weights)
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
