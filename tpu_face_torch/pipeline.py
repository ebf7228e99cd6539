"""FaceCascade: detect -> face ROI -> mesh -> both irises on one device,
and EmbedCascade: detect -> crop -> embed (counterparts of
tpu_face/pipeline.py).  Both share ``_DetectorBase``: the detector, the
frame planes and the detect stage, and the batched host API.

Per batch of same-size frames: build the channel planes once (f32 up to
~720p, bf16 beyond, as ``_plane_cfg`` decides); warp the whole frame for
detection (separable hat matmuls); BlazeFace + decode + weighted NMS to
``max_faces`` faces; the face ROIs; the mesh warp of every face of every
frame in ONE kernel launch and the mesh CNN; the eye ROIs; both iris
warps of every face in ONE kernel launch, the right eye mirrored through
its coordinates; the iris CNN on the stacked (left, mirrored right)
pairs; the mesh refinement.  The batch and the face axis are explicit
leading dimensions [B, K]; the nets take the flat [B*K] batch.

Stage semantics match the standalone models of the reference:
  detection    face_detection.rs:205-267
  face ROI     face_landmark.rs:180-198 (scale 1.5, SquareLong, eye rot)
  face mesh    face_landmark.rs:232-305
  eye ROIs     iris_landmark.rs:268-292 (scale 2.3, SquareLong)
  iris x2      iris_landmark.rs:158-248 (right eye mirrored)
  refinement   iris_landmark.rs:380-398

``__call__`` runs an installed program instead of ``_forward`` where
``tpu_face_torch.aot.attach`` put one for the frame size; otherwise, on
the card, it replays the CUDA graph of ``_forward`` that the cascade's
``programs.ProgramCache`` captured on the first call at that geometry
(the JAX package's per-geometry jit cache).  ``_forward`` is the eager
call.  ``replica`` builds the same cascade on another device for
``tpu_face_torch.parallel``.

``EmbedCascade`` crops each detected face axis-aligned (the reference's
int-truncated rect, intersected with the frame) to 112x112 and runs the
embedding net and the L2 norm on the flat [B*K] batch of crops.

With ``compute_dtype=torch.float32`` everything runs in full f32: TF32
is switched off for the convolutions and the matmuls while the cascade
runs (``exact_f32``).  With ``torch.bfloat16`` (the JAX package's bench
configuration) the nets compute in bf16 and, above 720 px, the
detection warp's hat matmuls run in bf16 with f32 accumulation; the ROI
warps and crops, the post-processing and the results stay f32.
"""

import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import exact_f32, resolve_device
from .compiler import Graph, build_torch_fn
from .models.face_detection import (_DATA_DIR, _MODEL_FILES, _SSD_OPTS,
                                    FaceDetectionModel)
from .models.face_embeddings import l2_normalize, load_embed_net
from .models.face_landmark import ROI_SCALE as MESH_ROI_SCALE
from .models.iris_landmark import (LEFT_EYE_END, LEFT_EYE_START,
                                   LEFT_EYE_TO_FACE_LANDMARK_INDEX,
                                   RIGHT_EYE_END, RIGHT_EYE_START,
                                   RIGHT_EYE_TO_FACE_LANDMARK_INDEX)
from .models.iris_landmark import ROI_SCALE as IRIS_ROI_SCALE
from .ops import anchors as anchors_lib
from .ops import geometry
from .ops import image as image_ops
from .ops import postprocess as post
from .ops import warp as warp_ops
from .programs import ProgramCache
from .utils import profiling


class CascadeResult(NamedTuple):
    """Per-image results of the cascade (leading batch axis), in the
    shapes of ``tpu_face.pipeline.CascadeResult``.  All coordinates are
    normalized to the input image.  With ``max_faces > 1`` every field
    gains a face axis after the batch axis (e.g. mesh [B, K, 468, 3]);
    with ``max_faces=1`` the shapes below apply."""

    detection: torch.Tensor      # [B, 8, 2] corners + 6 keypoints
    score: torch.Tensor          # [B] detection score
    face_valid: torch.Tensor     # [B] bool
    face_roi: torch.Tensor       # [B, 5] (cx, cy, w, h, rot) normalized
    mesh: torch.Tensor           # [B, 468, 3] refined with iris contours
    mesh_raw: torch.Tensor       # [B, 468, 3] before iris refinement
    mesh_score: torch.Tensor     # [B] presence score
    mesh_valid: torch.Tensor     # [B] bool: face_valid AND presence
    eye_rois: torch.Tensor       # [B, 2, 5] left/right normalized
    iris: torch.Tensor           # [B, 2, 5, 3] left/right iris landmarks
    envelope_ok: torch.Tensor    # [B] bool, always True: the CUDA warp
    # samples every ROI exactly (as the JAX exact-gather path does), and
    # JAX's "mxu" path reports True as well


def _norm_rotation(angle):
    two_pi = 2.0 * math.pi
    return angle - two_pi * torch.floor((angle + math.pi) / two_pi)


def _bbox_to_roi_abs(xmin, ymin, xmax, ymax, kp0, kp1, scale, w, h):
    """Normalized bbox [...] + two rotation keypoints [..., 2] -> ABS
    [..., 5] ROI: square-long sizing (transform.rs:87-109), rotation
    from the keypoint pair (transform.rs:62-75).  ``kp0``/``kp1`` are in
    the space the matching reference derivation uses: absolute pixels
    for the face ROI, normalized for the eye ROIs."""
    long_side = torch.maximum((xmax - xmin) * w, (ymax - ymin) * h)
    rw = long_side * scale[0]
    rh = long_side * scale[1]
    cx = (xmin + xmax) / 2.0 * w
    cy = (ymin + ymax) / 2.0 * h
    rot = _norm_rotation(-torch.atan2(kp0[..., 1] - kp1[..., 1],
                                      kp1[..., 0] - kp0[..., 0]))
    return torch.stack([cx, cy, rw, rh, rot], dim=-1)


def _scale_xy(pts, w, h):
    """Normalized points [..., 2] -> absolute pixels."""
    return torch.stack([pts[..., 0] * w, pts[..., 1] * h], dim=-1)


def _device_key(device) -> torch.device:
    """``device`` with its index: "cuda" means the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Traced(torch.nn.Module):
    """What ``torch.export`` traces (``tpu_face_torch.aot``): ``fn`` on
    tensors at one frame size, its result as a flat tuple, with the nets
    it runs as submodules, so that their weights become the program's
    state."""

    def __init__(self, fn, nets):
        super().__init__()
        self.fn = fn
        self.nets = torch.nn.ModuleList(nets)

    def forward(self, *args):
        return tuple(self.fn(*args))


def _roi_to_norm(roi_abs, w, h):
    """ABS ROIs [..., 5] -> normalized (rotation unchanged)."""
    inv_w, inv_h = 1.0 / w, 1.0 / h
    return torch.stack([roi_abs[..., 0] * inv_w, roi_abs[..., 1] * inv_h,
                        roi_abs[..., 2] * inv_w, roi_abs[..., 3] * inv_h,
                        roi_abs[..., 4]], dim=-1)


class _DetectorBase:
    """The detection front end the cascades share (``tpu_face.pipeline.
    _DetectorBase``): the detector, the frame planes, the whole-frame
    detect stage, and the batched host API (``infer_batch`` /
    ``__call__``).  ``FaceCascade`` adds the mesh and iris stages,
    ``EmbedCascade`` the crop and embed stage; each defines ``_forward``
    and its spans' labels (``_profile_label``, ``_call_label``)."""

    _profile_label = "cascade.infer_batch"
    _call_label = "cascade.call"
    _net_names = ("_det_net",)

    def _init_detection(self, detection_model, model_path, compute_dtype,
                        warp_method, max_faces, nms_top_m, input_layout,
                        warp_profile, device, methods, config):
        """Validate the shared arguments, resolve the device and the warp
        method (one of ``methods``), and build the detector.  ``config``
        holds the constructor's arguments but ``device``: ``replica``
        builds the same cascade on another device from them."""
        if int(max_faces) != max_faces or max_faces < 1:
            raise ValueError(f"max_faces must be a positive int, got "
                             f"{max_faces!r}")
        if input_layout not in ("hwc", "planar"):
            raise ValueError(f"input_layout {input_layout!r}")
        if warp_profile not in ("coverage", "speed", "auto"):
            raise ValueError(f"warp_profile {warp_profile!r}")
        self.device = resolve_device(device)
        self.warp_method = image_ops.resolve_warp_method(warp_method,
                                                         self.device)
        if self.warp_method not in methods:
            raise ValueError(f"warp_method {warp_method!r}: the cascade's "
                             f"ROIs rotate, so 'pallas', 'gather' or 'mxu'")
        self.compute_dtype = compute_dtype
        self.max_faces = int(max_faces)
        self.nms_top_m = nms_top_m
        self._layout = input_layout
        self._base = Path(model_path) if model_path else _DATA_DIR
        det_graph = Graph(self._base
                          / f"{_MODEL_FILES[detection_model]}.npz")
        self._det_net = build_torch_fn(det_graph, self.device,
                                       compute_dtype=compute_dtype)
        self.anchors = torch.from_numpy(anchors_lib.ssd_generate_anchors(
            _SSD_OPTS[detection_model])).to(self.device)
        _, self.det_h, self.det_w, _ = det_graph.input_shape
        self._whole_coords = {}
        self._config = config
        # (h, w) -> the installed program for frames of that size
        # (tpu_face_torch.aot.attach): __call__ runs it instead of _forward
        self._programs = {}
        # the CUDA graphs of _forward (and of the trackers' programs) by
        # geometry, captured on first use
        self._cache = ProgramCache(self.device)
        self._replicas = {}    # device -> this cascade on it (replica)

    # ---- batched host API ------------------------------------------

    def infer_batch(self, images):
        """Run the cascade on a batch (a single frame gains a batch
        axis)."""
        with profiling.stage(self._profile_label):
            if isinstance(images, np.ndarray):
                images = torch.from_numpy(np.require(images,
                                                     requirements="CW"))
            images = images.to(self.device)
            if images.dim() == 3:
                images = images[None]
            return self(images)

    def __call__(self, images):
        if self._layout == "planar":
            _, _, h, w = images.shape
        else:
            _, h, w, _ = images.shape
        program = self._programs.get((h, w))
        with (profiling.stage(self._call_label), torch.inference_mode(),
              exact_f32()):
            if program is not None:
                return program(images)
            return self._cache("forward",
                               lambda x: self._forward(x, (w, h)), images)

    # ---- serving: programs and replicas --------------------------------

    def _traced(self, fn, image_size):
        """``_Traced(fn)`` over this cascade's nets, for frames of
        ``image_size``; the detection warp's cached coordinates are made
        first, outside the trace."""
        self._whole_frame_coords(image_size)
        return _Traced(fn, [getattr(self, n) for n in self._net_names])

    def export_module(self, image_size):
        """The module ``torch.export`` traces for ``__call__`` on frames
        of ``image_size`` (w, h): ``_forward``."""
        return self._traced(lambda images: self._forward(images, image_size),
                            image_size)

    def replica(self, device):
        """This cascade on ``device``: itself on its own device, else one
        built from the same constructor arguments (the weights read
        again), once per device and kept."""
        key = _device_key(device)
        if key == _device_key(self.device):
            return self
        if key not in self._replicas:
            self._replicas[key] = type(self)(**self._config, device=key)
        return self._replicas[key]

    # ---- the shared stages -------------------------------------------

    @staticmethod
    def _plane_cfg(image_size):
        """Warp-plane type for this frame size (``pipeline._plane_cfg``
        of the JAX package): f32 while ``planes_fit_vmem`` holds (the
        TPU's resident kernel, up to ~720p), bf16 beyond it (its strip
        kernel).  On the card the rule only chooses the plane type and
        so the kernel (``warp.warp_sample_multi`` dispatches on it): every
        frame size takes the counterpart of the TPU kernel the JAX
        package takes there."""
        w, h = image_size
        return (torch.float32 if warp_ops.planes_fit_vmem(h, w)
                else torch.bfloat16)

    def _prepare_frame(self, images, image_size):
        """[B, 3, H, W] channel planes of the type ``_plane_cfg`` picks,
        built once per batch and read by the detection warp and every
        later warp or crop."""
        return warp_ops.make_planes(images, self._layout,
                                    self._plane_cfg(image_size))

    def _detect_stage(self, planes, image_size):
        """Whole-image detection + weighted NMS (reference
        face_detection.rs:205-267).  Returns (dets [B, K, 8, 2]
        normalized, scores [B, K], valid [B, K]) with K = max_faces."""
        w, h = image_size
        det_size = (self.det_w, self.det_h)
        with profiling.stage("detect"):
            # whole-image ROI has rotation 0: the warp is separable (two
            # hat matmuls).  Geometries whose int-truncated letterbox
            # pads make the reference's first resize non-identity (e.g.
            # 200x225 portraits) take the exact double resize.
            two = image_ops.letterbox_two_stage_params((w, h), det_size)
            if two is not None:
                tensor, padding = image_ops.letterbox_two_stage(
                    planes, (w, h), det_size, two, (-1.0, 1.0),
                    planar=True)
            else:
                # bf16 hat matmuls for large frames in a bf16 cascade, as
                # JAX's (at most one uint8 level; the f32 cascade stays
                # exact)
                dot_dtype = (torch.bfloat16
                             if (self.compute_dtype == torch.bfloat16
                                 and max(w, h) > 720) else None)
                dx, dy, padding = self._whole_frame_coords(image_size)
                tensor = image_ops._normalize_pixels(
                    image_ops.separable_sample_planar(
                        planes, dx, dy, dot_dtype=dot_dtype),
                    (-1.0, 1.0), True)
            raw_boxes, raw_scores = self._det_net(tensor)
        with profiling.stage("nms"):
            boxes = post.decode_boxes(raw_boxes, self.anchors,
                                      float(self.det_h))
            scores = post.clamped_sigmoid(
                raw_scores.reshape(raw_scores.shape[0], -1))
            valid = post.detection_validity(boxes, scores)
            out_d, out_s, out_v = post.weighted_nms(
                boxes, scores, valid, max_outputs=self.max_faces)
            return post.letterbox_removal(out_d, padding), out_s, out_v

    def _whole_frame_coords(self, image_size):
        """Detection-warp coordinates and letterbox padding of the
        whole-frame ROI, made once per frame geometry (device tensors
        made from host values would sync the stream on every call)."""
        if image_size not in self._whole_coords:
            w, h = image_size
            whole = torch.tensor([0.5 * w, 0.5 * h, w, h, 0.0],
                                 dtype=torch.float32, device=self.device)
            self._whole_coords[image_size] = image_ops._source_coords(
                whole, (self.det_w, self.det_h), True, False)
        return self._whole_coords[image_size]


class FaceCascade(_DetectorBase):
    """The fused cascade.

    ``infer_batch(images)`` takes a uint8/float batch [B, H, W, 3] (or
    [B, 3, H, W] with ``input_layout="planar"``; all frames the same
    size, numpy or torch) and returns a ``CascadeResult`` of tensors on
    the cascade's device.  ``device=None`` means the CUDA card and
    raises without one; pass ``device="cpu"`` for the plain path.

    ``compute_dtype`` is ``torch.float32`` or ``torch.bfloat16``, as in
    ``tpu_face.pipeline.FaceCascade``: in bf16 the detector, mesh and
    iris nets run in bf16 (``TFLiteNet``; the detector's residual runs on
    the fused kernel's bf16 entry point), and frames larger than 720 px
    on a side take bf16 hat matmuls in the detection warp
    (``separable_sample_planar(..., dot_dtype=torch.bfloat16)``).  The
    plane type still follows the frame size alone, the ROI warps do not
    change, and every result is f32.  Any other dtype raises.

    ``warp_method`` picks the ROI warps' sampler, as in
    ``tpu_face.pipeline.FaceCascade``: "pallas" the warp kernels
    (``warp.warp_sample_multi``), "gather" the plain zero-border gather
    (``warp.warp_bilinear_plain``) on either device, "mxu" the banded
    hat-weight matmuls (``image.mxu_sample``, plain torch ops, with the
    bands of ``_bands``), "auto" (``image.resolve_warp_method``) "pallas"
    on the card and "gather" on the CPU; any other value raises
    ``ValueError``.  The detection warp (two hat matmuls, no kernel) is
    the same for every method.

    ``detection_model`` is any ``FaceDetectionModel``; the full-range
    FULL and FULL_SPARSE detectors (192x192) run op by op, with no fused
    kernel.

    ``max_faces`` faces per frame come out of the weighted NMS; the
    per-face stages run over [B, max_faces].  Two arguments are accepted
    for parity with ``tpu_face.pipeline.FaceCascade`` and have no effect
    here:

    * ``warp_profile`` ("coverage", "speed" or "auto") picks the TPU
      warp kernels' block geometry and its static sampling window.  The
      card's warp kernels have no such window and sample every ROI
      exactly, so there is nothing to choose (``envelope_ok`` is always
      True).
    * ``nms_top_m`` bounds the candidate pool of ``plain_nms``; the
      weighted NMS always merges over the full pool, as in JAX."""

    def __init__(self,
                 detection_model: FaceDetectionModel =
                 FaceDetectionModel.BACK_CAMERA,
                 model_path: Optional[str] = None,
                 compute_dtype=torch.float32,
                 warp_method: str = "auto",
                 max_faces: int = 1,
                 nms_top_m: int = 128,
                 input_layout: str = "hwc",
                 warp_profile: str = "auto",
                 device=None):
        self._init_detection(detection_model, model_path, compute_dtype,
                             warp_method, max_faces, nms_top_m,
                             input_layout, warp_profile, device,
                             ("pallas", "gather", "mxu"), dict(
                                 detection_model=detection_model,
                                 model_path=model_path,
                                 compute_dtype=compute_dtype,
                                 warp_method=warp_method,
                                 max_faces=max_faces, nms_top_m=nms_top_m,
                                 input_layout=input_layout,
                                 warp_profile=warp_profile))
        mesh_graph = Graph(self._base / "face_landmark.npz")
        iris_graph = Graph(self._base / "iris_landmark.npz")
        self._mesh_net, self._iris_net = (
            build_torch_fn(g, self.device, compute_dtype=compute_dtype)
            for g in (mesh_graph, iris_graph))
        _, self.mesh_h, self.mesh_w, _ = mesh_graph.input_shape
        _, self.iris_h, self.iris_w, _ = iris_graph.input_shape
        self._left_idx = torch.tensor(LEFT_EYE_TO_FACE_LANDMARK_INDEX,
                                      device=self.device)
        self._right_idx = torch.tensor(RIGHT_EYE_TO_FACE_LANDMARK_INDEX,
                                       device=self.device)

    _net_names = ("_det_net", "_mesh_net", "_iris_net")

    # batched API (infer_batch / __call__): _DetectorBase's; returns a
    # CascadeResult

    def _forward(self, images, image_size):
        res = self._full(images, image_size)
        if self.max_faces == 1:
            # as in JAX: no face axis at max_faces=1
            res = CascadeResult(*(f[:, 0] for f in res))
        return res

    def _full(self, images, image_size):
        """The whole cascade over a batch [B, ...] of frames, every field
        with its face axis [B, K, ...] (any K): the trackers' full path
        and repair sub-batch."""
        planes = self._prepare_frame(images, image_size)
        dets, score, face_valid = self._detect_stage(planes, image_size)
        return self._face_stages(planes, dets, score, face_valid,
                                 image_size)

    def _face_stages(self, planes, det, score, face_valid, image_size,
                     face_roi_abs=None):
        """Stages 2-6 over faces [B, K]: the face ROIs (from ``det``
        [B, K, 8, 2], unless ``face_roi_abs`` [B, K, 5] gives them: the
        trackers derive them from the previous frame's mesh), the mesh
        half and the iris half, assembled into a ``CascadeResult`` with
        its face axis.  ``score`` and ``face_valid`` [B, K] pass through
        to the result (``mesh_valid`` requires ``face_valid``)."""
        if face_roi_abs is None:
            face_roi_abs = self._face_roi_from_det(det, image_size)
        mesh, mesh_score, left_roi, right_roi = self._mesh_half(
            planes, face_roi_abs, image_size)
        refined, l_iris, r_iris = self._iris_half(
            planes, mesh, left_roi, right_roi, image_size)
        return self._assemble_result(
            det, score, face_valid, face_roi_abs, mesh, refined,
            mesh_score, left_roi, right_roi, l_iris, r_iris, image_size)

    # ---- stages ------------------------------------------------------

    @staticmethod
    def _bands(image_size):
        """(mesh band, iris band) of the "mxu" warps: the source rows per
        8 output rows, scaled to the frame (copy of the JAX package's
        ``_DetectorBase._bands``; faces, and so ROIs, grow with the
        frame)."""
        w, h = image_size
        maxdim = max(image_size)

        def clamp8(v, lo, cap):
            return min(cap, max(lo, -(-v // 8) * 8))

        if maxdim > 2560:
            return (clamp8(maxdim // 12, 64, 192),
                    clamp8(maxdim // 12, 32, 192))
        if warp_ops.planes_fit_vmem(h, w):
            return clamp8(maxdim // 8, 96, 136), 72
        return 144, 144

    def _warp(self, planes, coords, band):
        """The ROI warps of one stage: ``warp_sample_multi`` (one kernel
        launch) for "pallas", ``warp_sample_multi_plain`` for "gather",
        ``mxu_sample`` with ``band`` rows (per grid) for "mxu"."""
        if self.warp_method == "gather":
            return warp_ops.warp_sample_multi_plain(planes, coords)
        if self.warp_method == "mxu":
            img = planes.movedim(1, -1).float()
            return [image_ops.mxu_sample(img, x, y, band=band)
                    for x, y in coords]
        return warp_ops.warp_sample_multi(planes, coords)

    def _face_roi_from_det(self, det, image_size):
        """Face ROIs [..., 5] of detections [..., 8, 2]
        (face_landmark.rs:180-198): keypoint rows 2 (left eye) and 3
        (right eye), scale 1.5, square-long."""
        w, h = image_size
        return _bbox_to_roi_abs(det[..., 0, 0], det[..., 0, 1],
                                det[..., 1, 0], det[..., 1, 1],
                                _scale_xy(det[..., 2, :], w, h),
                                _scale_xy(det[..., 3, :], w, h),
                                MESH_ROI_SCALE, w, h)

    def _mesh_half(self, planes, face_roi_abs, image_size):
        """Mesh warp + CNN + projection, then the eye ROIs, for face ROIs
        [B, K, 5].  Returns (mesh [B, K, 468, 3] normalized, mesh_score
        [B, K], left_roi [B, K, 5], right_roi [B, K, 5])."""
        w, h = image_size
        b, k = face_roi_abs.shape[:2]
        with profiling.stage("mesh_warp"):
            mx, my, mesh_pad = image_ops._source_coords(
                face_roi_abs, (self.mesh_w, self.mesh_h), False, False)
            (mesh_raw,) = self._warp(planes, [(mx, my)],
                                     self._bands(image_size)[0])
            mesh_tensor = image_ops._normalize_pixels(mesh_raw, (0.0, 1.0),
                                                      True)
        with profiling.stage("mesh"):
            raw_mesh, raw_flag = self._mesh_net(mesh_tensor.flatten(0, 1))
            mesh_score = torch.sigmoid(raw_flag.reshape(b, k))
            mesh = post.project_landmarks(
                raw_mesh.reshape(b, k, -1), (self.mesh_w, self.mesh_h),
                image_size, mesh_pad, face_roi_abs)

        # eye ROIs (iris_landmark.rs:268-292); rotation from NORMALIZED
        # landmark coordinates, as the reference computes it
        def eye_roi(i0, i1):
            p0, p1 = mesh[..., i0, :], mesh[..., i1, :]
            return _bbox_to_roi_abs(
                torch.minimum(p0[..., 0], p1[..., 0]),
                torch.minimum(p0[..., 1], p1[..., 1]),
                torch.maximum(p0[..., 0], p1[..., 0]),
                torch.maximum(p0[..., 1], p1[..., 1]),
                p0[..., :2], p1[..., :2], IRIS_ROI_SCALE, w, h)

        return (mesh, mesh_score, eye_roi(LEFT_EYE_START, LEFT_EYE_END),
                eye_roi(RIGHT_EYE_START, RIGHT_EYE_END))

    def _iris_half(self, planes, mesh, left_roi, right_roi, image_size):
        """Both iris warps of every face in one launch (right eye
        mirrored), the iris CNN on the stacked pairs, the projections and
        the mesh refinement (iris_landmark.rs:158-248, 380-398).  Returns
        (refined mesh [B, K, 468, 3], l_iris [B, K, 5, 3], r_iris
        [B, K, 5, 3])."""
        size = (self.iris_w, self.iris_h)
        with profiling.stage("iris_warp"):
            lx, ly, lp = image_ops._source_coords(left_roi, size, True,
                                                  False)
            rx, ry, rp = image_ops._source_coords(right_roi, size, True,
                                                  True)
            l_raw, r_raw = self._warp(planes, [(lx, ly), (rx, ry)],
                                      self._bands(image_size)[1])
            # stacked channel-major [B, K, 2, 3, Ho, Wo], handed to the
            # net as its NHWC view of [2BK, 3, Ho, Wo]
            pair = torch.stack([l_raw.movedim(-1, -3),
                                r_raw.movedim(-1, -3)], dim=2)
            pair = image_ops._normalize_pixels(pair, (0.0, 1.0), True)
        b, k = pair.shape[:2]
        with profiling.stage("iris"):
            raw_contour, raw_iris = self._iris_net(
                pair.flatten(0, 2).permute(0, 2, 3, 1))
        raw_contour = raw_contour.reshape(b, k, 2, -1)
        raw_iris = raw_iris.reshape(b, k, 2, -1)

        def project(raw, roi_abs, pad, flip):
            return post.project_landmarks(raw, size, image_size, pad,
                                          roi_abs, flip_horizontal=flip)

        l_contour = project(raw_contour[:, :, 0], left_roi, lp, False)
        r_contour = project(raw_contour[:, :, 1], right_roi, rp, True)
        l_iris = project(raw_iris[:, :, 0], left_roi, lp, False)
        r_iris = project(raw_iris[:, :, 1], right_roi, rp, True)

        refined = mesh.index_copy(2, self._left_idx, l_contour)
        refined = refined.index_copy(2, self._right_idx, r_contour)
        return refined, l_iris, r_iris

    def _assemble_result(self, det, score, face_valid, face_roi_abs,
                         mesh, refined, mesh_score, left_roi, right_roi,
                         l_iris, r_iris, image_size):
        w, h = image_size
        return CascadeResult(
            detection=det,
            score=score,
            face_valid=face_valid,
            face_roi=_roi_to_norm(face_roi_abs, w, h),
            mesh=refined,
            mesh_raw=mesh,
            mesh_score=mesh_score,
            mesh_valid=face_valid & (mesh_score > 0.5),
            eye_rois=_roi_to_norm(torch.stack([left_roi, right_roi], dim=-2),
                                  w, h),
            iris=torch.stack([l_iris, r_iris], dim=-3),
            envelope_ok=torch.ones_like(face_valid),
        )


class EmbedResult(NamedTuple):
    """Per-image results of the identification pipeline (leading batch
    axis; with ``max_faces > 1`` a face axis follows it), in the shapes
    of ``tpu_face.pipeline.EmbedResult``."""

    detection: torch.Tensor   # [B, 8, 2] corners + 6 keypoints (norm)
    score: torch.Tensor       # [B] detection score
    face_valid: torch.Tensor  # [B] bool
    crop_bbox: torch.Tensor   # [B, 4] ABSOLUTE (x0, y0, x1, y1) crop used
    embedding: torch.Tensor   # [B, D] L2-normalized feature vector


class EmbedCascade(_DetectorBase):
    """Detect -> crop -> embed identification pipeline
    (``tpu_face.pipeline.EmbedCascade``).

    Per batch: the detector and its weighted NMS (``_DetectorBase``),
    each face's axis-aligned crop (the reference's int-truncated rect,
    intersected with the frame: ``ops.geometry.crop_roi_from_detection``)
    resized to the embedding net's 112x112 in range (0, 1), the net on the
    flat [B*K] batch of crops and the L2 norm.  Crops of invalid faces are
    finite garbage that ``face_valid`` masks.

    The crop by ``warp_method``, as in JAX: "pallas" ("auto" on the card)
    the two separable hat matmuls over the frame planes the detector
    read (``separable_sample_planar``; no warp kernel), "gather" the
    plain zero-border gather, "mxu" and "separable" the separable hat
    matmuls over the frames (JAX passes "separable" for "mxu").  The
    embedding net has no run for the fused kernel and runs op by op; the
    BACK detector's residual runs take the fused kernel.

    ``warp_profile`` is validated and ignored, as in ``FaceCascade``.
    The embeddings model is not bundled: ``embed_model_path`` (else
    ``model_path``, else the JAX package's data directory) must hold a
    converted ``face_embeddings.npz``; ``tpu_face/data/demo`` has one with
    synthetic weights.  ``device=None`` means the CUDA card and raises
    without one."""

    _profile_label = "embed_cascade.infer_batch"
    _call_label = "embed_cascade.call"

    def __init__(self,
                 detection_model: FaceDetectionModel =
                 FaceDetectionModel.BACK_CAMERA,
                 model_path: Optional[str] = None,
                 embed_model_path: Optional[str] = None,
                 compute_dtype=torch.float32,
                 warp_method: str = "auto",
                 max_faces: int = 1,
                 nms_top_m: int = 128,
                 input_layout: str = "hwc",
                 warp_profile: str = "auto",
                 device=None):
        self._init_detection(detection_model, model_path, compute_dtype,
                             warp_method, max_faces, nms_top_m,
                             input_layout, warp_profile, device,
                             image_ops.WARP_METHODS, dict(
                                 detection_model=detection_model,
                                 model_path=model_path,
                                 embed_model_path=embed_model_path,
                                 compute_dtype=compute_dtype,
                                 warp_method=warp_method,
                                 max_faces=max_faces, nms_top_m=nms_top_m,
                                 input_layout=input_layout,
                                 warp_profile=warp_profile))
        egraph, self._embed_net = load_embed_net(
            embed_model_path or model_path, compute_dtype, self.device)
        _, self.embed_h, self.embed_w, _ = egraph.input_shape

    _net_names = ("_det_net", "_embed_net")

    # batched API (infer_batch / __call__): _DetectorBase's; returns an
    # EmbedResult

    def _forward(self, images, image_size):
        planes = self._prepare_frame(images, image_size)
        dets, score, face_valid = self._detect_stage(planes, image_size)
        roi_abs, crop_bbox = geometry.crop_roi_from_detection(
            dets[..., :2, :], image_size, xp=torch)
        with profiling.stage("embed_crop"):
            tensor = self._crop(planes, roi_abs)
        with profiling.stage("embed"):
            (raw,) = self._embed_net(tensor.flatten(0, 1))
            b, k = dets.shape[:2]
            emb = l2_normalize(raw.reshape(b, k, -1))
        res = EmbedResult(detection=dets, score=score, face_valid=face_valid,
                          crop_bbox=crop_bbox, embedding=emb)
        if self.max_faces == 1:
            # as in JAX: no face axis at max_faces=1
            res = EmbedResult(*(f[:, 0] for f in res))
        return res

    def _crop(self, planes, roi_abs):
        """The faces' 112x112 crops [B, K, Ho, Wo, 3] in range (0, 1) of
        axis-aligned ABS ROIs [B, K, 5] over the planes [B, 3, H, W]."""
        ex, ey, _ = image_ops._source_coords(
            roi_abs, (self.embed_w, self.embed_h), False, False)
        if self.warp_method == "pallas":
            # every face against its frame's planes: [B, 1, 3, H, W]
            out = image_ops.separable_sample_planar(planes[:, None], ex, ey)
        elif self.warp_method == "gather":
            (out,) = warp_ops.warp_sample_multi_plain(planes, [(ex, ey)])
        else:
            frames = planes.movedim(1, -1).float()[:, None]
            out = image_ops.separable_sample(frames, ex, ey)
        return image_ops._normalize_pixels(out, (0.0, 1.0), True)
