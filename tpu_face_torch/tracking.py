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

The JAX version makes both choices with ``lax.cond`` inside one jitted
program per frame size, and so does ``step`` here: ``_step_fn`` takes
them with ``programs.cond``, and on the card it runs through the
cascade's ``programs.ProgramCache`` as one CUDA graph per frame size and
batch, the two decisions conditional (IF) nodes.  A replay runs the taken
branches' kernels only (a locked step launches no detector kernel), and
nothing of the step is read back to the host.  On the CPU the same
function runs eagerly and takes its branches by reading the predicates.
JAX nests the repair's cond inside the tracked branch; here it follows
the first cond, its predicate false after the full path, which makes the
same decisions with two IF nodes side by side.  (Nested, on an H100
under the CUDA 12.8 driver, the end of the tracked body's capture
crashed inside the driver whenever both bodies ran the iris net;
``programs.cond`` itself nests.)

An exported tracker (``tpu_face_torch.aot``) holds the programs the
branches call: the full cascade at the step's batch B and at the repair
batch, and the tracked stages at B.  With such programs attached, and
over ``tpu_face_torch.parallel.track_sharded``'s shards (one replica
tracker per device of a mesh, each holding its streams' state there), a
step takes its decisions on the host over all B streams
(``_step_shards``, one device-to-host read for each decision), and its
branches call the attached programs or the cascade's three cached
sub-programs.
"""

import copy
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import exact_f32, programs
from .models.face_detection import FaceDetectionModel, frames_on
from .models.face_landmark import ROI_SCALE as MESH_ROI_SCALE
from .pipeline import (CascadeResult, FaceCascade, _bbox_to_roi_abs,
                       _scale_xy)
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
    return _bbox_to_roi_abs(lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1],
                            _scale_xy(mesh[..., _ROT_LEFT, :2], w, h),
                            _scale_xy(mesh[..., _ROT_RIGHT, :2], w, h),
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


@functools.lru_cache(maxsize=None)
def _dummy_roi(image_size, device):
    """A unit ROI at the frame centre for slots without a usable ROI
    (their stages still run, NaN-free; the result is masked), made once
    per frame size and device: a tensor made from host values in every
    call could not be captured."""
    w, h = image_size
    return torch.tensor([w / 2.0, h / 2.0, 64.0, 64.0, 0.0],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _force_flags(device):
    """(False, True) as device bool scalars, made once per device: the
    step program's ``force`` input, with no host copy per step."""
    return (torch.zeros((), dtype=torch.bool, device=device),
            torch.ones((), dtype=torch.bool, device=device))


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


def _repairs(lost, r):
    """The repair of a tracked step over shards whose lost flags are
    ``lost`` (one [B_i] tensor each, the streams in shard order): the
    first ``r`` streams of the whole batch with the lost ones first
    (``_lost_first``), as [(shard, local indices, their lost flags)], one
    entry per shard that holds any of them; [] when no stream is lost.
    One host read, and a second one of the indices with several
    shards."""
    whole = torch.cat([flags.to(lost[0].device) for flags in lost])
    if not bool(whole.any()):
        return []
    sel = _lost_first(whole, r)
    if len(lost) == 1:
        return [(0, sel, whole[sel])]
    sel = sel.cpu()
    parts, first = [], 0
    for i, flags in enumerate(lost):
        mine = sel[(sel >= first) & (sel < first + flags.shape[0])] - first
        if mine.numel():
            mine = mine.to(flags.device)
            parts.append((i, mine, flags[mine]))
        first += flags.shape[0]
    return parts


def _cat_state(states, device):
    """Per-shard states (one NamedTuple each) as one on ``device``."""
    return type(states[0])(*(torch.cat([f.to(device) for f in fields])
                             for fields in zip(*states)))


class TrackerPrograms(NamedTuple):
    """The installed programs of an attached artifact
    (``tpu_face_torch.aot.attach``) for one frame size: ``full`` {batch:
    the full cascade with its face axis} at the step's batch and the
    repair batch, ``tracked`` the tracked stages at the step's batch."""

    batch: int
    full: dict
    tracked: object


def _merge(cur, sub, sel, take):
    """``cur`` with rows ``sel`` replaced by ``sub``'s where ``take``
    [len(sel)] holds, field by field."""
    def one(a, b):
        mask = take.reshape((-1,) + (1,) * (b.dim() - 1))
        a = a.clone()
        a[sel] = torch.where(mask, b, a[sel])
        return a
    return type(cur)(*(one(a, b) for a, b in zip(cur, sub)))


def _one_face(res):
    """A result with a face axis of one, without it."""
    return CascadeResult(*(f[:, 0] for f in res))


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
        # (h, w) -> TrackerPrograms (aot.attach)
        self._programs = {}
        # (mesh, [replica trackers]) while track_sharded holds the streams'
        # state in shards (``_state`` is then None)
        self._shards = None
        self._replicas = {}    # (shard index, device) -> replica

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
        if self._state is not None:
            held = self._state.valid.shape[0]
        elif self._shards is not None:
            held = sum(t._state.valid.shape[0] for t in self._shards[1])
        else:
            held = None
        if held == b and self._state_hw == hw:
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
        self._shards = None
        if self._smoother is not None:
            self._smoother.reset()

    def replica(self, device):
        """A tracker over this one's cascade on ``device``
        (``FaceCascade.replica``), without state, smoother or installed
        programs: a shard of ``track_sharded``."""
        rep = copy.copy(self)
        rep.cascade = self.cascade.replica(device)
        rep.device = rep.cascade.device
        rep._smoother = None
        rep._programs, rep._replicas = {}, {}
        rep._state = rep._shards = None
        return rep

    def export_modules(self, image_size, batch):
        """{name: (module torch.export traces, example inputs)} of the
        programs a step at ``batch`` streams of ``image_size`` (w, h)
        frames calls: "full" and, where the repair batch differs,
        "repair" (the full cascade with its face axis), and "tracked"."""
        c = self.cascade
        w, h = image_size
        k = c.max_faces
        shape = ((3, h, w) if c._layout == "planar" else (h, w, 3))

        def images(n):
            return torch.zeros((n,) + shape, dtype=torch.uint8,
                               device=self.device)

        full = c._traced(lambda x: c._full(x, image_size), image_size)
        tracked = c._traced(
            lambda x, roi, valid: _tracked_stages(c, x, roi, valid,
                                                  image_size), image_size)
        rois = torch.zeros(batch, k, 5, device=self.device)
        _dummy_roi(image_size, rois.device)    # made outside the trace
        out = {"full": (full, (images(batch),)),
               "tracked": (tracked, (
                   images(batch), rois,
                   torch.zeros(batch, k, dtype=torch.bool,
                               device=self.device)))}
        r = self._repair_n(batch)
        if r != batch:
            out["repair"] = (full, (images(r),))
        return out

    def _replica_at(self, i, device):
        """Shard ``i``'s replica tracker on ``device``, made once."""
        if (i, device) not in self._replicas:
            self._replicas[i, device] = self.replica(device)
        return self._replicas[i, device]

    def _run_full(self, images, image_size):
        """The full cascade over ``images`` with its face axis: the
        installed program where there is one (at the step's batch or the
        repair batch), else ``FaceCascade._full`` through the cascade's
        program cache."""
        progs = self._programs.get((image_size[1], image_size[0]))
        if progs is not None:
            return progs.full[images.shape[0]](images)
        c = self.cascade
        return c._cache("full", lambda x: c._full(x, image_size), images)

    def _run_tracked(self, images, rois, valid, image_size):
        """The tracked stages over faces [B, K] (``_tracked_stages``): the
        installed program where there is one, else the cascade's program
        cache."""
        progs = self._programs.get((image_size[1], image_size[0]))
        if progs is not None:
            return progs.tracked(images, rois, valid)
        c = self.cascade
        return c._cache("tracked",
                        lambda x, r, v: _tracked_stages(c, x, r, v,
                                                        image_size),
                        images, rois, valid)

    def _held_state(self):
        """The state of all streams (gathered from ``track_sharded``'s
        shards onto the tracker's device), None before the first step."""
        if self._shards is not None:
            return _cat_state([t._state for t in self._shards[1]],
                              self.device)
        return self._state

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
        since the previous frame, read only by the optional smoother.  The
        step is ``_step_fn`` through the cascade's program cache (one CUDA
        graph per frame size and batch on the card), or with attached
        programs ``_step_shards`` over this one shard."""
        images, hw = self._frames(images)
        b = images.shape[0]
        progs = self._programs.get(hw)
        if progs is not None and b != progs.batch:
            raise ValueError(f"the attached artifact's programs take "
                             f"{progs.batch} streams (its saved batch), "
                             f"got {b}")
        # the streams come back from track_sharded's shards, if it has them
        self._state, self._shards = self._held_state(), None
        if self._fresh(b, hw):
            self._state = self._empty_state(b)
        force, size = self.next_step_forced, (hw[1], hw[0])
        with torch.inference_mode(), exact_f32():
            if progs is not None:
                (res,) = self._step_shards([(self, images)], force, size,
                                           self._repair_n(b))
            else:
                res, self._state = self.cascade._cache(
                    "step", lambda x, *state: self._step_fn(x, *state, size),
                    images, *self._state, _force_flags(self.device)[force])
        self._steps += 1
        return self._smooth_result(res, dt)

    def _sharded_step(self, chunks, mesh) -> CascadeResult:
        """``step`` over a batch split into ``chunks``, chunk i on device
        ``mesh[i]`` (``tpu_face_torch.parallel.track_sharded``): each
        shard's streams are stepped by a replica tracker on its device,
        which holds their state there; the decisions (a forced step, mass
        loss, which streams the repair takes) are taken over all B
        streams, as ``step`` takes them.  Returns the result of all B
        streams on the tracker's device."""
        key = tuple(str(torch.device(d)) for d in mesh)
        if self._shards is not None and self._shards[0] != key:
            self._state, self._shards = self._held_state(), None
        reps = (self._shards[1] if self._shards is not None else
                [self._replica_at(i, d) for i, d in enumerate(key)])
        frames, hws = zip(*(rep._frames(x) for rep, x in zip(reps, chunks)))
        hw = hws[0]
        sizes = [x.shape[0] for x in frames]
        b = sum(sizes)
        if self._fresh(b, hw):
            for rep, n in zip(reps, sizes):
                rep._state = rep._empty_state(n)
        elif self._shards is None:
            # the streams' state goes out to the shards
            parts = [f.split(sizes) for f in self._state]
            for i, rep in enumerate(reps):
                rep._state = type(self._state)(*(p[i].to(rep.device)
                                                 for p in parts))
        self._state, self._shards = None, (key, reps)
        force = self.next_step_forced
        with torch.inference_mode(), exact_f32():
            parts = self._step_shards(list(zip(reps, frames)), force,
                                      (hw[1], hw[0]), self._repair_n(b))
        self._steps += 1
        res = type(parts[0])(*(torch.cat([f.to(self.device) for f in fields])
                               for fields in zip(*parts)))
        return self._smooth_result(res)


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
        every stream (``_run_tracked`` with one face a stream)."""
        return _one_face(self._run_tracked(images, roi[:, None],
                                           valid[:, None], image_size))

    @staticmethod
    def _next_state(res, image_size):
        return TrackerState(roi_from_mesh(res.mesh, image_size),
                            res.mesh_valid)

    def _step_fn(self, images, roi, valid, force, image_size):
        """One step over all B streams (``tpu_face.tracking.FaceTracker.
        _step_fn``): the full cascade for every stream on a forced
        redetect or mass entry loss (beyond one repair pass, or every
        stream: the first step), else the tracked stages; then, if a
        tracked stream is lost, the full cascade over the first ``r``
        streams with the lost ones first, merged back.  Both decisions are
        ``programs.cond``.  Returns (result, next state)."""
        c = self.cascade
        b = images.shape[0]
        r = self._repair_n(b)
        n_lost = (~valid).sum()
        use_full = force | (n_lost > r) | (n_lost == b)

        def full(images, roi, valid):
            return _one_face(c._full(images, image_size))

        def tracked(images, roi, valid):
            return _one_face(_tracked_stages(c, images, roi[:, None],
                                             valid[:, None], image_size))

        def repair(res, lost):
            sel = _lost_first(lost, r)
            sub = _one_face(c._full(images[sel], image_size))
            return _merge(res, sub, sel, lost[sel])

        res = programs.cond(use_full, full, tracked, (images, roi, valid))
        # unusable tracked output: no entry ROI, or presence lost; the full
        # path leaves nothing to repair (the module docstring says why the
        # repair's cond follows the first instead of lying inside it)
        lost = ~(use_full | (valid & res.mesh_valid))
        res = programs.cond(lost.any(), repair, lambda res, _: res,
                            (res, lost))
        return res, self._next_state(res, image_size)

    def _step_shards(self, shards, force, image_size, r):
        """``_step_fn`` over ``shards`` [(tracker, frames)] (each tracker
        holding its streams' state) with the decisions taken on the host
        over all their streams and the stages run by ``_run_full`` and
        ``_run_tracked``; ``r`` the repair batch of all streams.  Returns
        each shard's result and updates each state."""
        b = sum(x.shape[0] for _, x in shards)
        n_lost = 0 if force else b - sum(int(t._state.valid.sum())
                                         for t, _ in shards)
        if force or n_lost > r or n_lost == b:
            res = [_one_face(t._run_full(x, image_size)) for t, x in shards]
        else:
            res = [t._tracked(x, *t._state, image_size) for t, x in shards]
            lost = [~(t._state.valid & out.mesh_valid)
                    for (t, _), out in zip(shards, res)]
            for i, sel, take in _repairs(lost, r):
                t, x = shards[i]
                res[i] = _merge(res[i],
                                _one_face(t._run_full(x[sel], image_size)),
                                sel, take)
        for (t, _), out in zip(shards, res):
            t._state = self._next_state(out, image_size)
        return res

    @property
    def tracking(self) -> np.ndarray:
        """Per-stream bool: True streams enter the next step on the
        detection-free tracked path."""
        state = self._held_state()
        if state is None:
            return np.zeros(0, bool)
        return state.valid.cpu().numpy()


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
                    _roi_iou_matrix(new_roi, prev_roi), -1.0)
    lead = m.shape[:-2]
    m = m.reshape(-1, k, k)
    n = m.shape[0]
    rows = torch.arange(n, device=m.device)
    slots = torch.arange(k, device=m.device)
    slot_src = torch.full((n, k), -1, dtype=torch.int64, device=m.device)
    used = torch.zeros((n, k), dtype=torch.bool, device=m.device)
    for _ in range(k):
        flat = m.reshape(n, -1).argmax(-1)
        i, j = flat // k, flat % k
        ok = m.reshape(n, -1)[rows, flat] > iou_thresh
        slot_src[rows, j] = torch.where(ok, i, slot_src[rows, j])
        used[rows, i] |= ok
        # the matched pair's row and column leave the matrix
        hit = ((slots[None, :, None] == i[:, None, None])
               | (slots[None, None, :] == j[:, None, None]))
        m = m.masked_fill(hit & ok[:, None, None], -1.0)
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

    @staticmethod
    def _reordered(res, rois, valid, image_size):
        """A full cascade's result ``res`` with each frame's faces put in
        the previous slots' order (``match_slots`` against the slots'
        ROIs and flags)."""
        w, h = image_size
        roi = res.face_roi
        roi_abs = torch.stack([roi[..., 0] * w, roi[..., 1] * h,
                               roi[..., 2] * w, roi[..., 3] * h,
                               roi[..., 4]], -1)
        perm = match_slots(roi_abs, res.mesh_valid, rois, valid)
        return type(res)(*(
            f.gather(1, perm.reshape(perm.shape + (1,) * (f.dim() - 2))
                     .expand(perm.shape + f.shape[2:]))
            for f in res))

    def _detected(self, images, rois, valid, image_size):
        """The full cascade over ``images`` (``_run_full``), reordered
        into the previous slots (``_reordered``)."""
        return self._reordered(self._run_full(images, image_size), rois,
                               valid, image_size)

    @staticmethod
    def _lost(locked, valid, res):
        """The streams whose tracked output ``res`` is unusable (entered
        unlocked, or a tracked face lost presence), and the lock flags
        of the others."""
        lost = ~locked | (valid & ~res.mesh_valid).any(-1)
        return lost, ~lost & res.mesh_valid.any(-1)

    @staticmethod
    def _repaired(res, locked, sub, sel, take):
        """``res`` and the lock flags ``locked`` with the repair's result
        ``sub`` of streams ``sel`` merged in where ``take`` holds."""
        locked = locked.clone()
        locked[sel] = torch.where(take, sub.mesh_valid.any(-1), locked[sel])
        return _merge(res, sub, sel, take), locked

    @staticmethod
    def _next_state(res, locked, image_size):
        return MultiTrackerState(roi_from_mesh(res.mesh, image_size),
                                 res.mesh_valid, locked)

    def _step_fn(self, images, rois, valid, locked, force, image_size):
        """One step over all B streams (``tpu_face.tracking.
        MultiFaceTracker._step_fn``): the full cascade, its faces matched
        to the slots, for every stream on a forced redetect or mass loss of
        lock, else the tracked stages over the B*K slots; then, if a
        tracked stream is lost, the matched full cascade over the first
        ``r`` streams with the lost ones first, merged back.  Both
        decisions are ``programs.cond`` (the second after the first, as
        in ``FaceTracker._step_fn``).  Returns (result, next state)."""
        c = self.cascade
        b = images.shape[0]
        r = self._repair_n(b)
        n_unlocked = (~locked).sum()
        use_full = force | (n_unlocked > r) | (n_unlocked == b)

        def full(images, rois, valid, locked):
            res = self._reordered(c._full(images, image_size), rois, valid,
                                  image_size)
            return res, res.mesh_valid.any(-1)

        def tracked(images, rois, valid, locked):
            res = _tracked_stages(c, images, rois, valid, image_size)
            return res, self._lost(locked, valid, res)[1]

        def repair(res, ok, lost):
            sel = _lost_first(lost, r)
            sub = self._reordered(c._full(images[sel], image_size),
                                  rois[sel], valid[sel], image_size)
            return self._repaired(res, ok, sub, sel, lost[sel])

        res, ok = programs.cond(use_full, full, tracked,
                                (images, rois, valid, locked))
        lost = ~use_full & self._lost(locked, valid, res)[0]
        res, next_locked = programs.cond(lost.any(), repair,
                                         lambda res, ok, _: (res, ok),
                                         (res, ok, lost))
        return res, self._next_state(res, next_locked, image_size)

    def _step_shards(self, shards, force, image_size, r):
        """``_step_fn`` over ``shards`` [(tracker, frames)] (each tracker
        holding its streams' state) with the decisions taken on the host
        over all their streams and the stages run by ``_run_full`` and
        ``_run_tracked``; ``r`` the repair batch of all streams.  Returns
        each shard's result and updates each state."""
        b = sum(x.shape[0] for _, x in shards)
        n_unlocked = 0 if force else b - sum(int(t._state.locked.sum())
                                             for t, _ in shards)
        if force or n_unlocked > r or n_unlocked == b:
            res = [t._detected(x, *t._state[:2], image_size)
                   for t, x in shards]
            next_locked = [out.mesh_valid.any(-1) for out in res]
        else:
            res = [t._run_tracked(x, *t._state[:2], image_size)
                   for t, x in shards]
            lost, next_locked = zip(*(
                self._lost(t._state.locked, t._state.valid, out)
                for (t, _), out in zip(shards, res)))
            next_locked = list(next_locked)
            for i, sel, take in _repairs(lost, r):
                (t, x), (rois, valid, _) = shards[i], shards[i][0]._state
                sub = t._detected(x[sel], rois[sel], valid[sel], image_size)
                res[i], next_locked[i] = self._repaired(
                    res[i], next_locked[i], sub, sel, take)
        for (t, _), out, locked in zip(shards, res, next_locked):
            t._state = self._next_state(out, locked, image_size)
        return res

    @property
    def tracking(self) -> np.ndarray:
        """Per-stream bool: True streams enter the next step on the
        detection-free tracked path."""
        state = self._held_state()
        if state is None:
            return np.zeros(0, bool)
        return state.locked.cpu().numpy()

    @property
    def face_count(self) -> np.ndarray:
        """Per-stream count of the faces tracked now."""
        state = self._held_state()
        if state is None:
            return np.zeros(0, np.int32)
        return state.valid.sum(-1).cpu().numpy().astype(np.int32)
