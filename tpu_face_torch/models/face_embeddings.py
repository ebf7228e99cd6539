"""ArcFace-style face embeddings (counterpart of
tpu_face/models/face_embeddings.py).

API parity with the reference ``FaceEmbeddings`` (face_embeddings.rs:
22-109): axis-aligned bbox crop, resize to 112x112 in range (0, 1), the
CNN, global L2 normalization, in one pass on the model's device per call.
Like the reference, the model file is not bundled: convert it with
``tools/convert_tflite.py`` and pass the directory that holds
``face_embeddings.npz``.  ``tpu_face/data/demo/`` holds a MobileFaceNet
graph of that class with synthetic weights (no semantic meaning), which
the tests and ``chip_smoke.py`` run.

The crop is axis-aligned, so "pallas" (and "auto" on the card) samples it
with the two separable hat matmuls, as the JAX module does: no warp
kernel runs here.  "gather" and "mxu" take those samplers.  The
embedding net (MobileFaceNet: PReLU blocks that widen C -> 2C / 4C) has
no run for the fused residual-block kernel and runs op by op.
"""

import enum
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import exact_f32, resolve_device
from ..compiler import Graph, build_torch_fn
from ..ops import geometry
from ..ops import image as image_ops
from ..programs import ProgramCache
from ..types import BBox
from ..utils.image_io import load_image
from .face_detection import _DATA_DIR, frames_on

IMG_SIZE = 112  # reference face_embeddings.rs:20


class FeatureCount(enum.IntEnum):
    """Embedding widths the model family ships in
    (reference face_embeddings.rs:15-18)."""

    FEATURE_128 = 128
    FEATURE_512 = 512


def load_embed_net(model_path, compute_dtype, device):
    """(graph, lowered net) of ``<model_path>/face_embeddings.npz``, with
    the JAX module's error where the converted model is missing."""
    npz = Path(model_path or _DATA_DIR) / "face_embeddings.npz"
    if not npz.exists():
        raise FileNotFoundError(
            f"converted model not found: {npz} — the embeddings model "
            f"is not bundled (see reference README); download "
            f"face_embeddings.tflite and run tools/convert_tflite.py")
    graph = Graph(npz)
    return graph, build_torch_fn(graph, device, compute_dtype=compute_dtype)


def l2_normalize(raw):
    """Rows of ``raw`` [..., D] over their global norm, as the JAX
    package computes it: ``flat * rsqrt(max(sum(flat^2), 1e-12))``; the
    eps keeps degenerate crops NaN-free (utils.rs:30-33 divides
    unguarded; real embeddings have norms far beyond it)."""
    return raw * torch.rsqrt(torch.clamp(
        torch.sum(raw * raw, dim=-1, keepdim=True), min=1e-12))


class FaceEmbeddings:
    """Face feature extractor: ``infer(image, bbox)`` -> L2-normalized
    embedding vector (128 or 512 floats).  Runs on the card unless
    ``device="cpu"`` (and raises without one); ``compute_dtype`` float32
    or bfloat16 sets the net's, the crop stays f32."""

    def __init__(self, model_path: Optional[str] = None,
                 compute_dtype=torch.float32, warp_method: str = "auto",
                 device=None):
        self.device = resolve_device(device)
        self.graph, self._net = load_embed_net(model_path, compute_dtype,
                                               self.device)
        _, self.in_h, self.in_w, _ = self.graph.input_shape
        self._warp = image_ops.resolve_warp_method(warp_method, self.device)
        self._cache = ProgramCache(self.device)

    # ---- the device pass ----------------------------------------------

    def _pipeline(self, images, roi_abs):
        """[N, H, W, 3] frames + [N, 5] axis-aligned abs ROIs -> [N, D]
        L2-normalized embeddings."""
        # the crop is axis-aligned, so the separable two-matmul path is
        # exact wherever the warp kernel would be used
        tensor, _ = image_ops.warp_image_to_tensor(
            images, roi_abs, (self.in_w, self.in_h),
            keep_aspect_ratio=False, output_range=(0.0, 1.0),
            method=("separable" if self._warp == "pallas" else self._warp))
        (raw,) = self._net(tensor)
        return l2_normalize(raw.reshape(raw.shape[0], -1))

    def _run(self, images, roi_abs):
        with torch.inference_mode(), exact_f32():
            return self._cache("pipeline", self._pipeline, images, roi_abs)

    # ---- host API ------------------------------------------------------

    def infer(self, image, bbox: BBox) -> np.ndarray:
        """Embed the face inside ``bbox`` (absolute pixel coordinates,
        int-truncated like the reference's Mat::roi crop,
        face_embeddings.rs:101-109)."""
        img = load_image(image)
        roi = torch.from_numpy(self._roi_from_bbox(bbox)[None])
        out = self._run(frames_on(img[None], self.device),
                        roi.to(self.device))
        return out[0].cpu().numpy()

    @staticmethod
    def _roi_from_bbox(bb) -> np.ndarray:
        """BBox (or (xmin, ymin, xmax, ymax) tuple) -> axis-aligned
        (5,) abs ROI with the reference's int-truncated crop semantics
        (face_embeddings.rs:101-109)."""
        vals = ((bb.xmin, bb.ymin, bb.xmax, bb.ymax)
                if isinstance(bb, BBox) else tuple(float(v) for v in bb))
        x, y = int(vals[0]), int(vals[1])
        cw, ch = int(vals[2] - vals[0]), int(vals[3] - vals[1])
        if cw <= 0 or ch <= 0:
            raise ValueError(f"empty crop bbox: {vals}")
        return np.array([x + cw / 2.0, y + ch / 2.0, cw, ch, 0.0],
                        np.float32)

    def infer_batch(self, images, bboxes) -> np.ndarray:
        """Batched embeddings: [B, H, W, 3] same-size RGB frames (numpy
        or torch) + B bboxes (``BBox`` or (xmin, ymin, xmax, ymax),
        absolute pixels) -> [B, D] L2-normalized vectors, in one pass on
        the device."""
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        b = images.shape[0]
        if len(bboxes) != b:
            raise ValueError(f"{b} images but {len(bboxes)} bboxes")
        rois = np.stack([self._roi_from_bbox(bb) for bb in bboxes])
        out = self._run(frames_on(images, self.device),
                        torch.from_numpy(rois).to(self.device))
        return out.cpu().numpy()

    def embed_boxes(self, images, boxes, as_numpy: bool = True,
                    layout: str = "hwc"):
        """Embed boxes or landmark sets that may already lie on the
        device, without a host round trip of the coordinates (the
        video-identification hand-off):

        >>> res = cascade.infer_batch(frames)          # CascadeResult
        >>> embs = emb.embed_boxes(frames, res.mesh)

        ``boxes`` (numpy or torch) accepts, per image, with an optional
        face axis K:

        * ``[..., 2, 2]`` normalized corner rows or ``[..., 4]``: a
          detection-style bbox (Detection rows 0-1);
        * ``[..., N>=3, 3]`` normalized landmarks (e.g. the 468-point
          mesh): their tight bounding box, reduced on the device.

        ``images``: [B, H, W, 3], or [B, 3, H, W] with
        ``layout="planar"``.  The crop is
        ``ops.geometry.crop_roi_from_detection`` (int-truncated,
        intersected with the frame), as in ``pipeline.EmbedCascade``;
        invalid or degenerate boxes give finite garbage, to be masked
        with the caller's validity flags.  Returns [B, D] (or
        [B, K, D]); ``as_numpy=False`` keeps the result on the device.
        Where JAX nests a vmap over the faces, the K crops of a frame run
        here as one flat batch of B*K."""
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        if layout not in ("hwc", "planar"):
            raise ValueError(f"layout must be hwc|planar, got {layout}")
        if images.ndim != 4 or images.shape[1 if layout == "planar"
                                            else 3] != 3:
            raise ValueError(
                f"images must be [B, H, W, 3] (or [B, 3, H, W] with "
                f"layout='planar'), got {tuple(images.shape)}")
        frames = frames_on(images, self.device)
        if layout == "planar":
            frames = frames.permute(0, 2, 3, 1)
        b, h, w = frames.shape[:3]
        boxes = torch.as_tensor(boxes).to(self.device)
        from_mesh = (boxes.dim() >= 2 and boxes.shape[-1] == 3
                     and boxes.shape[-2] > 2)
        if from_mesh:
            xy = boxes[..., :2].float()
            boxes = torch.stack([xy.amin(-2), xy.amax(-2)], dim=-2)
        elif boxes.shape[-1] == 4:
            boxes = boxes.reshape(boxes.shape[:-1] + (2, 2))
        if boxes.shape[0] != b:
            raise ValueError(f"{b} images but {boxes.shape[0]} box "
                             f"rows (leading dims must agree)")
        lead = boxes.shape[:-2]

        def crop_embed(frames, boxes):
            roi_abs, _ = geometry.crop_roi_from_detection(
                boxes, (w, h), xp=torch)
            if len(lead) == 2:
                frames = frames.repeat_interleave(lead[1], dim=0)
            return self._pipeline(frames, roi_abs.reshape(-1, 5))

        with torch.inference_mode(), exact_f32():
            out = self._cache("boxes", crop_embed, frames, boxes)
        out = out.reshape(*lead, -1)
        return out.cpu().numpy() if as_numpy else out
