"""FaceTracker and MultiFaceTracker: the cascade over video, with
detection-free tracking (counterpart of tpu_face/tracking.py).

While a stream's previous mesh is present, its next face ROI comes from
that mesh (bbox over all 468 points, rotation from the eye-outer pair,
scale 1.5 square-long) and only the mesh and iris stages run: the
detector does not run on a locked step.  One step serves B parallel
streams, with the state (ROIs [B, 5], lock flags [B]) on the cascade's
device.  The step runs the tracked stages for every stream; if any
stream's tracked output is unusable, up to ``repair_batch`` lost streams
go through the full cascade as a sub-batch and their results are
scattered back.  Mass loss (more lost streams than one repair pass
covers, or every stream, as on the first step) and forced redetects
(``redetect_every``) run the full cascade for every stream.

The JAX version makes both choices with ``lax.cond`` inside one
program.  Here they are host branches: each step reads whether the full
path is due, and on the tracked path whether any stream is lost, with one
device-to-host copy each.  The outputs are the contract.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import exact_f32
from .models.face_detection import FaceDetectionModel, frames_on
from .models.face_landmark import ROI_SCALE as MESH_ROI_SCALE
from .pipeline import CascadeResult, FaceCascade, _bbox_to_roi_abs
from .smoothing import OneEuroConfig, ResultSmoother

# rotation keypoints of landmark-derived ROIs: the eye outer corners (the
# pair the upstream tracking graph uses)
_ROT_LEFT = 33
_ROT_RIGHT = 263


class TrackerState(NamedTuple):
    roi: torch.Tensor     # [B, 5] absolute (cx, cy, w, h, rot)
    valid: torch.Tensor   # [B] bool: ROI usable for the next frame


def roi_from_mesh(mesh, image_size: Tuple[int, int]):
    """Next-frame face ROIs [..., 5] (absolute) from normalized meshes
    [..., 468, 3]: bbox over all landmarks, rotation from the eye-outer
    pair, scale 1.5 square-long (the tracking analogue of
    face_detection_to_roi, reference face_landmark.rs:180-198)."""
    w, h = image_size
    xy = mesh[..., :2]
    lo, hi = xy.amin(-2), xy.amax(-2)
    scale = torch.tensor([w, h], dtype=torch.float32, device=mesh.device)
    return _bbox_to_roi_abs(lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1],
                            mesh[..., _ROT_LEFT, :2] * scale,
                            mesh[..., _ROT_RIGHT, :2] * scale,
                            MESH_ROI_SCALE, w, h)


def _det_from_roi(roi_abs, image_size):
    """Detection rows [..., 8, 2] carrying tracked ROIs' bboxes (the ROI
    itself goes to the stages directly, not rederived from these
    rows)."""
    w, h = image_size
    half = torch.stack([roi_abs[..., 2] / w, roi_abs[..., 3] / h], -1) / 2.0
    center = torch.stack([roi_abs[..., 0] / w, roi_abs[..., 1] / h], -1)
    zeros = torch.zeros(roi_abs.shape[:-1] + (6, 2), dtype=torch.float32,
                        device=roi_abs.device)
    return torch.cat([(center - half)[..., None, :],
                      (center + half)[..., None, :], zeros], -2)


def _dummy_roi(image_size, device):
    """A unit ROI at the frame centre for slots without a usable ROI
    (their stages still run, NaN-free; the result is masked)."""
    w, h = image_size
    return torch.tensor([w / 2.0, h / 2.0, 64.0, 64.0, 0.0],
                        dtype=torch.float32, device=device)


def _tracked_stages(cascade, images, rois, valid, image_size):
    """The mesh and iris stages over faces [B, K] from tracked ROIs [B, K,
    5].  A slot's entry lock state ``valid`` [B, K] flows into
    ``face_valid`` and ``score``: a slot without a usable ROI runs on a
    dummy ROI and must not surface as a face unless the repair reaches
    it."""
    safe = torch.where(valid[..., None], rois,
                       _dummy_roi(image_size, rois.device))
    planes = cascade._prepare_frame(images, image_size)
    return cascade._face_stages(planes, _det_from_roi(safe, image_size),
                                valid.float(), valid, image_size,
                                face_roi_abs=safe)


def _lost_first(lost, r):
    """The first ``r`` stream indices with the lost ones first, in index
    order (a stable sort, as ``jnp.argsort``)."""
    return torch.argsort((~lost).to(torch.int8), stable=True)[:r]


def _merge(cur, sub, sel, take):
    """``cur`` with rows ``sel`` replaced by ``sub``'s where ``take``
    [len(sel)] holds, field by field."""
    def one(a, b):
        mask = take.reshape((-1,) + (1,) * (b.dim() - 1))
        a = a.clone()
        a[sel] = torch.where(mask, b, a[sel])
        return a
    return type(cur)(*(one(a, b) for a, b in zip(cur, sub)))


class _TrackerBase:
    """What both trackers share: the cascade, the repair size, the
    redetect schedule, the smoother and the frame intake."""

    def _init_cascade(self, detection_model, model_path, compute_dtype,
                      warp_method, max_faces, input_layout, warp_profile,
                      device, redetect_every, repair_batch, smoothing):
        self.cascade = FaceCascade(detection_model, model_path=model_path,
                                   compute_dtype=compute_dtype,
                                   warp_method=warp_method,
                                   max_faces=max_faces,
                                   input_layout=input_layout,
                                   warp_profile=warp_profile, device=device)
        self.device = self.cascade.device
        # force a detector pass every N steps even while locked (guards
        # against slow drift); None = only on tracking loss
        self.redetect_every = redetect_every
        # per-step detection sub-batch for lost streams; None = B // 8
        # (min 1).  More simultaneous losses take the full path
        self.repair_batch = repair_batch
        self._init_smoothing(smoothing)
        self._state = None
        self._state_hw: Optional[Tuple[int, int]] = None
        self._steps = 0

    def _repair_n(self, b: int) -> int:
        r = (self.repair_batch if self.repair_batch is not None
             else max(1, b // 8))
        return min(r, b)

    def _init_smoothing(self, smoothing):
        """Opt-in OneEuro smoothing of the OUTPUT mesh and iris ("one_euro"
        or an ``OneEuroConfig``): the next-frame ROIs keep following the
        raw mesh, so the tracking itself is unchanged."""
        if smoothing is None:
            self._smoother = None
            return
        cfg = OneEuroConfig() if smoothing == "one_euro" else smoothing
        if not isinstance(cfg, OneEuroConfig):
            raise TypeError("smoothing must be None, 'one_euro' or an "
                            f"OneEuroConfig, got {smoothing!r}")
        self._smoother = ResultSmoother(cfg, device=self.device)

    def _smooth_result(self, res, dt=None):
        if self._smoother is None:
            return res
        mesh, iris = self._smoother(res.mesh, res.iris, res.mesh_valid,
                                    dt=dt)
        return res._replace(mesh=mesh, iris=iris)

    def _frames(self, images):
        """(frames [B, ...] on the device, (h, w))."""
        images = frames_on(images, self.device)
        if images.dim() == 3:
            images = images[None]
        if self.cascade._layout == "planar":
            return images, tuple(images.shape[2:4])
        return images, tuple(images.shape[1:3])

    def _fresh(self, b, hw):
        """Whether the state must start afresh: none yet, or the batch
        size or the frame resolution changed (ROIs are absolute pixels of
        the previous resolution)."""
        if (self._state is not None and self._state.valid.shape[0] == b
                and self._state_hw == hw):
            return False
        self._state_hw = hw
        if self._smoother is not None:
            # normalized shapes are resolution-blind: the filter cannot
            # see this reset on its own
            self._smoother.reset()
        return True

    def reset(self):
        self._state = None
        self._state_hw = None
        self._steps = 0
        if self._smoother is not None:
            self._smoother.reset()

    @property
    def next_step_forced(self) -> bool:
        """True when the next ``step()`` forces a detector pass for every
        stream whatever its lock state (the ``redetect_every`` schedule;
        a fresh tracker's first step detects through the mass-loss path
        instead)."""
        return (self.redetect_every is not None
                and self._steps % self.redetect_every == 0)

    def step(self, images, dt=None) -> CascadeResult:
        """One tracked step over a frame batch [B, ...].  ``dt``: seconds
        since the previous frame, read only by the optional smoother."""
        images, hw = self._frames(images)
        if self._fresh(images.shape[0], hw):
            self._state = self._empty_state(images.shape[0])
        force = self.next_step_forced
        with torch.inference_mode(), exact_f32():
            res, self._state = self._step(images, force, (hw[1], hw[0]))
        self._steps += 1
        return self._smooth_result(res, dt)


class FaceTracker(_TrackerBase):
    """Stateful video cascade over B parallel streams, one face each.

    >>> tracker = FaceTracker()
    >>> for frames in video_batches:          # [8, H, W, 3] each
    ...     result = tracker.step(frames)     # CascadeResult [8, ...]

    The arguments are ``tpu_face.tracking.FaceTracker``'s, plus
    ``device``: the card unless ``device="cpu"`` (raising without one)."""

    def __init__(self,
                 detection_model: FaceDetectionModel =
                 FaceDetectionModel.BACK_CAMERA,
                 model_path: Optional[str] = None,
                 compute_dtype=torch.float32,
                 warp_method: str = "auto",
                 redetect_every: Optional[int] = None,
                 input_layout: str = "hwc",
                 repair_batch: Optional[int] = None,
                 warp_profile: str = "auto",
                 smoothing=None,
                 device=None):
        self._init_cascade(detection_model, model_path, compute_dtype,
                           warp_method, 1, input_layout, warp_profile,
                           device, redetect_every, repair_batch, smoothing)

    def _empty_state(self, b):
        return TrackerState(
            torch.zeros(b, 5, dtype=torch.float32, device=self.device),
            torch.zeros(b, dtype=torch.bool, device=self.device))

    def _tracked(self, images, roi, valid, image_size):
        """The mesh and iris stages from the state's ROIs [B, 5], for
        every stream (``_tracked_stages`` with one face a stream)."""
        res = _tracked_stages(self.cascade, images, roi[:, None],
                              valid[:, None], image_size)
        return CascadeResult(*(f[:, 0] for f in res))

    def _step(self, images, force, image_size):
        c = self.cascade
        roi, valid = self._state
        b = images.shape[0]
        r = self._repair_n(b)
        # the full path for forced redetects or mass entry loss: beyond
        # one repair pass, or every stream (the first step)
        n_lost = b - int(valid.sum()) if not force else 0
        if force or n_lost > r or n_lost == b:
            res = c._forward(images, image_size)
        else:
            res = self._tracked(images, roi, valid, image_size)
            # unusable tracked output: no entry ROI, or presence lost
            lost = ~(valid & res.mesh_valid)
            if bool(lost.any()):
                sel = _lost_first(lost, r)
                res = _merge(res, c._forward(images[sel], image_size), sel,
                             lost[sel])
        return res, TrackerState(roi_from_mesh(res.mesh, image_size),
                                 res.mesh_valid)

    @property
    def tracking(self) -> np.ndarray:
        """Per-stream bool: True streams enter the next step on the
        detection-free tracked path."""
        if self._state is None:
            return np.zeros(0, bool)
        return self._state.valid.cpu().numpy()


def _roi_iou_matrix(a, b):
    """IoU of the axis-aligned bounds of two ROI sets [..., K, 5] ->
    [..., K, K]."""
    def box(r):
        return torch.stack([r[..., 0] - r[..., 2] / 2,
                            r[..., 1] - r[..., 3] / 2,
                            r[..., 0] + r[..., 2] / 2,
                            r[..., 1] + r[..., 3] / 2], -1)

    ab, bb = box(a)[..., :, None, :], box(b)[..., None, :, :]
    x0 = torch.maximum(ab[..., 0], bb[..., 0])
    y0 = torch.maximum(ab[..., 1], bb[..., 1])
    x1 = torch.minimum(ab[..., 2], bb[..., 2])
    y1 = torch.minimum(ab[..., 3], bb[..., 3])
    inter = torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)
    area_a = (ab[..., 2] - ab[..., 0]) * (ab[..., 3] - ab[..., 1])
    area_b = (bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def match_slots(new_roi, new_valid, prev_roi, prev_valid,
                iou_thresh: float = 0.1):
    """Greedy IoU assignment of K re-detected faces to K previous slots
    ([..., K, 5] ROIs, [..., K] flags; any leading dims), keeping
    identities stable across a re-detection.

    Returns perm [..., K] (int64) such that slot j takes new face
    perm[j].  Matched pairs (IoU > thresh) keep their slot; unmatched new
    faces fill the unmatched slots in NMS score order.  With no valid
    previous slot the permutation is the identity.  K greedy rounds, each
    over the whole batch."""
    k = new_roi.shape[-2]
    m = torch.where(new_valid[..., :, None] & prev_valid[..., None, :],
                    _roi_iou_matrix(new_roi, prev_roi),
                    torch.tensor(-1.0, device=new_roi.device))
    lead = m.shape[:-2]
    m = m.reshape(-1, k, k).clone()
    n = m.shape[0]
    rows = torch.arange(n, device=m.device)
    slot_src = torch.full((n, k), -1, dtype=torch.int64, device=m.device)
    used = torch.zeros((n, k), dtype=torch.bool, device=m.device)
    for _ in range(k):
        flat = m.reshape(n, -1).argmax(-1)
        i, j = flat // k, flat % k
        ok = m.reshape(n, -1)[rows, flat] > iou_thresh
        slot_src[rows, j] = torch.where(ok, i, slot_src[rows, j])
        used[rows, i] |= ok
        cleared = m.clone()
        cleared[rows, i, :] = -1.0
        cleared[rows, :, j] = -1.0
        m = torch.where(ok[:, None, None], cleared, m)
    unmatched = slot_src < 0
    rank = unmatched.long().cumsum(-1) - 1
    # unmatched new faces in ascending index (NMS score order) fill the
    # unmatched slots in slot order
    order = torch.argsort(used.to(torch.int8), dim=-1, stable=True)
    fill = order.gather(-1, rank.clamp(0, k - 1))
    return torch.where(unmatched, fill, slot_src).reshape(*lead, k)


class MultiTrackerState(NamedTuple):
    roi: torch.Tensor      # [B, K, 5] absolute per-face ROIs
    valid: torch.Tensor    # [B, K] bool: slot holds a tracked face
    locked: torch.Tensor   # [B] bool: stream may skip the detector


class MultiFaceTracker(_TrackerBase):
    """K-face video tracking over B parallel streams.

    Like ``FaceTracker``, but each stream tracks up to ``max_faces``
    faces: while a stream is locked, each valid slot derives its next ROI
    from its own previous mesh and only the mesh and iris stages run,
    over the B*K faces.  A stream whose tracked output becomes unusable
    (it entered unlocked, or a tracked face lost presence) is re-detected
    by the bounded repair sub-batch; mass loss takes the full path.  Every
    detector pass matches the new faces to the previous slots
    (``match_slots``), so a surviving face keeps its slot.  Faces that
    enter the scene are only found by the detector: ``redetect_every``
    rediscovers them periodically.  Every field has its face axis, also
    with ``max_faces=1``.

    >>> tracker = MultiFaceTracker(max_faces=4)
    >>> for frames in video_batches:          # [B, H, W, 3]
    ...     result = tracker.step(frames)     # CascadeResult [B, K, ...]
    """

    def __init__(self,
                 detection_model: FaceDetectionModel =
                 FaceDetectionModel.BACK_CAMERA,
                 model_path: Optional[str] = None,
                 max_faces: int = 4,
                 compute_dtype=torch.float32,
                 warp_method: str = "auto",
                 redetect_every: Optional[int] = None,
                 input_layout: str = "hwc",
                 repair_batch: Optional[int] = None,
                 warp_profile: str = "auto",
                 smoothing=None,
                 device=None):
        if int(max_faces) != max_faces or max_faces < 1:
            raise ValueError(f"max_faces must be a positive int, got "
                             f"{max_faces!r}")
        self.max_faces = int(max_faces)
        self._init_cascade(detection_model, model_path, compute_dtype,
                           warp_method, self.max_faces, input_layout,
                           warp_profile, device, redetect_every,
                           repair_batch, smoothing)

    def _empty_state(self, b):
        k = self.max_faces
        return MultiTrackerState(
            torch.zeros(b, k, 5, dtype=torch.float32, device=self.device),
            torch.zeros(b, k, dtype=torch.bool, device=self.device),
            torch.zeros(b, dtype=torch.bool, device=self.device))

    def _detected(self, images, rois, valid, image_size):
        """The full cascade over ``images``, each frame's faces put in
        the previous slots' order (``match_slots``)."""
        w, h = image_size
        res = self.cascade._full(images, image_size)
        scale = torch.tensor([w, h, w, h, 1.0], dtype=torch.float32,
                             device=self.device)
        perm = match_slots(res.face_roi * scale, res.mesh_valid, rois,
                           valid)
        return type(res)(*(
            f.gather(1, perm.reshape(perm.shape + (1,) * (f.dim() - 2))
                     .expand(perm.shape + f.shape[2:]))
            for f in res))

    def _step(self, images, force, image_size):
        c = self.cascade
        rois, valid, locked = self._state
        b = images.shape[0]
        r = self._repair_n(b)
        n_unlocked = b - int(locked.sum()) if not force else 0
        if force or n_unlocked > r or n_unlocked == b:
            res = self._detected(images, rois, valid, image_size)
            next_locked = res.mesh_valid.any(-1)
        else:
            res = _tracked_stages(c, images, rois, valid, image_size)
            lost = ~locked | (valid & ~res.mesh_valid).any(-1)
            next_locked = ~lost & res.mesh_valid.any(-1)
            if bool(lost.any()):
                sel = _lost_first(lost, r)
                take = lost[sel]
                sub = self._detected(images[sel], rois[sel], valid[sel],
                                     image_size)
                res = _merge(res, sub, sel, take)
                next_locked = next_locked.clone()
                next_locked[sel] = torch.where(take, sub.mesh_valid.any(-1),
                                               next_locked[sel])
        return res, MultiTrackerState(roi_from_mesh(res.mesh, image_size),
                                      res.mesh_valid, next_locked)

    @property
    def tracking(self) -> np.ndarray:
        """Per-stream bool: True streams enter the next step on the
        detection-free tracked path."""
        if self._state is None:
            return np.zeros(0, bool)
        return self._state.locked.cpu().numpy()

    @property
    def face_count(self) -> np.ndarray:
        """Per-stream count of the faces tracked now."""
        if self._state is None:
            return np.zeros(0, np.int32)
        return self._state.valid.sum(-1).cpu().numpy().astype(np.int32)
