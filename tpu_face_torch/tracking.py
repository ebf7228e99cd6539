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

An exported tracker (``tpu_face_torch.aot``) is the same ``_step_fn`` as
one program, "step", with JAX's inputs in JAX's order ((images, roi,
valid, force), or (images, rois, valid, locked, force)), its two
decisions ``torch.cond`` nodes; attached, ``step`` calls it with the
held state.  Such a program reads each predicate on the host when it
runs (as XLA's GPU conditional does).

``tpu_face_torch.parallel.track_sharded`` splits the streams over
replica trackers, one per device of a mesh, each holding its streams'
state there.  A sharded step (``_sharded_step``) takes the unsharded
step's decisions over all B streams without a host read: the entry
decision and the repair's selection are computed on the tracker's
device from each shard's flags, copied there device to device; each
shard runs its cached "shard_stage" program (the first cond) and its
"shard_finish" program (the repair's cond over a fixed ``r`` rows, the
rows another shard owns masked off, then the next state).  Each shard
that holds a repaired stream repairs ``r`` frames, where the unsharded
step repairs ``r`` in all.
"""

import copy
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import exact_f32, programs
from .models.face_detection import FaceDetectionModel, frames_on
from .models.face_landmark import ROI_SCALE as MESH_ROI_SCALE
from .pipeline import (CascadeResult, FaceCascade, _bbox_to_roi_abs,
                       _scale_xy)
from .smoothing import OneEuroConfig, ResultSmoother
from .utils import profiling

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


def _labelled(name, fn):
    """``fn`` in the span ``name`` (``utils.profiling``): a branch of the
    step's conds, so that a traced step shows which ran."""
    def run(*args):
        with profiling.stage(name):
            return fn(*args)
    return run


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


def _cat_state(states, device):
    """Per-shard states (one NamedTuple each) as one on ``device``."""
    return type(states[0])(*(torch.cat([f.to(device) for f in fields])
                             for fields in zip(*states)))


def _use_full(unlocked, force, r):
    """The entry decision over B streams whose unlocked flags are
    ``unlocked`` [B]: a forced redetect, or mass loss (more unlocked
    streams than one repair pass of ``r`` covers, or every stream, as on
    the first step)."""
    n = unlocked.sum()
    return force | (n > r) | (n == unlocked.shape[0])


def _put(a, sel, take, b):
    """``a`` with rows ``sel`` set to ``b``'s where ``take`` [len(sel)]
    holds.  The rows not taken are written to a spare row past the end,
    which is dropped: ``sel`` may repeat a row it does not take (a
    shard's padding)."""
    spare = torch.cat([a, a[:1]])
    spare[torch.where(take, sel, a.shape[0])] = b
    return spare[:-1]


def _merge(cur, sub, sel, take):
    """``cur`` with rows ``sel`` replaced by ``sub``'s where ``take``
    [len(sel)] holds, field by field (``_put``)."""
    return type(cur)(*(_put(a, sel, take, b) for a, b in zip(cur, sub)))


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
        # (h, w) -> the attached "step" program (aot.attach)
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
        """{"step": (module torch.export traces, example inputs)}:
        ``_step_fn`` at ``batch`` streams of ``image_size`` (w, h) frames,
        taking JAX's inputs in JAX's order (the frames, the state's
        fields, ``force`` a bool scalar) and returning the fields of the
        result and of the next state."""
        c = self.cascade
        w, h = image_size
        shape = ((3, h, w) if c._layout == "planar" else (h, w, 3))
        images = torch.zeros((batch,) + shape, dtype=torch.uint8,
                             device=self.device)
        # made outside the trace, keyed by the device the stages see
        # ("cuda:0", where the tracker's may be "cuda")
        _dummy_roi(image_size, images.device)
        step = c._traced(lambda x, *args: pytree.tree_leaves(
            self._step_fn(x, *args, image_size)), image_size)
        return {"step": (step, (images, *self._empty_state(batch),
                                _force_flags(self.device)[0]))}

    def _replica_at(self, i, device):
        """Shard ``i``'s replica tracker on ``device``, made once."""
        if (i, device) not in self._replicas:
            self._replicas[i, device] = self.replica(device)
        return self._replicas[i, device]

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
        graph per frame size and batch on the card), or the attached
        "step" program."""
        images, hw = self._frames(images)
        b = images.shape[0]
        program = self._programs.get(hw)
        if program is not None and b != program.batch:
            raise ValueError(f"the attached artifact's step program takes "
                             f"{program.batch} streams (its saved batch), "
                             f"got {b}")
        # the streams come back from track_sharded's shards, if it has them
        self._state, self._shards = self._held_state(), None
        if self._fresh(b, hw):
            self._state = self._empty_state(b)
        force = _force_flags(self.device)[self.next_step_forced]
        size = (hw[1], hw[0])
        with torch.inference_mode(), exact_f32():
            if program is not None:
                res, self._state = program(images, *self._state, force)
            else:
                res, self._state = self.cascade._cache(
                    "step", lambda x, *state: self._step_fn(x, *state, size),
                    images, *self._state, force)
        self._steps += 1
        return self._smooth_result(res, dt)

    def _step_fn(self, images, *args):
        """One step over all B streams (``tpu_face.tracking``'s
        ``FaceTracker._step_fn`` and ``MultiFaceTracker._step_fn``):
        ``args`` the state's fields, ``force`` (a bool scalar) and the
        frame size (w, h).  The full cascade for every stream on a forced
        redetect or mass loss of lock (``_use_full``), else the tracked
        stages (``_stage``); then, if a tracked stream is lost, the full
        cascade over the first ``r`` streams with the lost ones first,
        merged back (``_finish``).  Both decisions are ``programs.cond``.
        Returns (result, next state)."""
        *state, force, image_size = args
        state = self._State(*state)
        r = self._repair_n(images.shape[0])
        use_full = _use_full(self._unlocked(state), force, r)
        staged, lost = self._stage(images, state, use_full, image_size)
        sel = _lost_first(lost, r)
        return self._finish(images, state, staged, sel, lost[sel],
                            image_size)

    def _shard_stage(self, image_size, images, *args):
        """``_stage`` on a shard's tensors: its frames, its state's fields
        and the entry decision of all streams (the "shard_stage"
        program)."""
        *state, use_full = args
        return self._stage(images, self._State(*state), use_full,
                           image_size)

    def _shard_finish(self, image_size, tree, images, *args):
        """``_finish`` on a shard's tensors: its frames, its state's
        fields, the leaves of its ``_stage`` output (tree ``tree``), its
        ``r`` repair rows and their take flags (the "shard_finish"
        program)."""
        k = len(self._State._fields)
        staged = pytree.tree_unflatten(list(args[k:-2]), tree)
        return self._finish(images, self._State(*args[:k]), staged,
                            *args[-2:], image_size)

    def _sharded_step(self, chunks, mesh) -> CascadeResult:
        """``step`` over a batch split into ``chunks``, chunk i on device
        ``mesh[i]`` (``tpu_face_torch.parallel.track_sharded``): each
        shard's streams are stepped by a replica tracker on its device,
        which holds their state there.  The decisions (a forced step,
        mass loss, which streams the repair takes) are taken over all B
        streams, as ``step`` takes them, on the tracker's device and
        without a host read (the module docstring says how).  Returns the
        result of all B streams on the tracker's device."""
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
        force = _force_flags(self.device)[self.next_step_forced]
        size, r = (hw[1], hw[0]), self._repair_n(b)
        with torch.inference_mode(), exact_f32():
            use_full = _use_full(torch.cat([
                self._unlocked(rep._state).to(self.device) for rep in reps]),
                force, r)
            staged = [rep.cascade._cache(
                "shard_stage", functools.partial(rep._shard_stage, size), x,
                *rep._state, use_full.to(rep.device))
                for rep, x in zip(reps, frames)]
            lost = torch.cat([flags.to(self.device) for _, flags in staged])
            sel = _lost_first(lost, r)
            take = lost[sel]
            parts, first = [], 0
            for rep, x, (out, _) in zip(reps, frames, staged):
                mine = (sel >= first) & (sel < first + x.shape[0])
                leaves, tree = pytree.tree_flatten(out)
                res, rep._state = rep.cascade._cache(
                    "shard_finish",
                    functools.partial(rep._shard_finish, size, tree), x,
                    *rep._state, *leaves,
                    torch.where(mine, sel - first, 0).to(rep.device),
                    (mine & take).to(rep.device))
                parts.append(res)
                first += x.shape[0]
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

    _State = TrackerState

    def _empty_state(self, b):
        return TrackerState(
            torch.zeros(b, 5, dtype=torch.float32, device=self.device),
            torch.zeros(b, dtype=torch.bool, device=self.device))

    @staticmethod
    def _unlocked(state):
        return ~state.valid

    @staticmethod
    def _next_state(res, image_size):
        return TrackerState(roi_from_mesh(res.mesh, image_size),
                            res.mesh_valid)

    def _stage(self, images, state, use_full, image_size):
        """The first decision over a batch of streams: the full cascade
        where ``use_full`` holds, else the tracked stages from the
        state's ROIs.  Returns (result, lost [B]): the streams whose
        tracked output is unusable (no entry ROI, or presence lost; none
        after the full path)."""
        c = self.cascade

        def full(images, roi, valid):
            return _one_face(c._full(images, image_size))

        def tracked(images, roi, valid):
            return _one_face(_tracked_stages(c, images, roi[:, None],
                                             valid[:, None], image_size))

        res = programs.cond(use_full, _labelled("track.full", full),
                            _labelled("track.tracked", tracked),
                            (images, *state))
        return res, ~(use_full | (state.valid & res.mesh_valid))

    def _finish(self, images, state, res, sel, take, image_size):
        """The repair's decision (the module docstring says why it follows
        the first cond instead of lying inside it): where a stream of
        ``take`` holds, the full cascade over the ``r`` streams ``sel``,
        merged back where ``take`` holds.  Returns (result, next
        state)."""
        c = self.cascade

        def repair(res, sel, take):
            sub = _one_face(c._full(images[sel], image_size))
            return _merge(res, sub, sel, take)

        res = programs.cond(take.any(), _labelled("track.repair", repair),
                            lambda res, *_: res, (res, sel, take))
        return res, self._next_state(res, image_size)

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

    _State = MultiTrackerState

    def _empty_state(self, b):
        k = self.max_faces
        return MultiTrackerState(
            torch.zeros(b, k, 5, dtype=torch.float32, device=self.device),
            torch.zeros(b, k, dtype=torch.bool, device=self.device),
            torch.zeros(b, dtype=torch.bool, device=self.device))

    @staticmethod
    def _unlocked(state):
        return ~state.locked

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
        return (_merge(res, sub, sel, take),
                _put(locked, sel, take, sub.mesh_valid.any(-1)))

    @staticmethod
    def _next_state(res, locked, image_size):
        return MultiTrackerState(roi_from_mesh(res.mesh, image_size),
                                 res.mesh_valid, locked)

    def _stage(self, images, state, use_full, image_size):
        """The first decision over a batch of streams: the full cascade,
        its faces matched to the slots, where ``use_full`` holds, else the
        tracked stages over the B*K slots.  Returns ((result, lock flags
        of the streams it leaves usable), lost [B]: the streams whose
        tracked output is unusable, none after the full path)."""
        c = self.cascade

        def full(images, rois, valid, locked):
            res = self._reordered(c._full(images, image_size), rois, valid,
                                  image_size)
            return res, res.mesh_valid.any(-1)

        def tracked(images, rois, valid, locked):
            res = _tracked_stages(c, images, rois, valid, image_size)
            return res, self._lost(locked, valid, res)[1]

        res, ok = programs.cond(use_full, _labelled("track.full", full),
                                _labelled("track.tracked", tracked),
                                (images, *state))
        lost = ~use_full & self._lost(state.locked, state.valid, res)[0]
        return (res, ok), lost

    def _finish(self, images, state, staged, sel, take, image_size):
        """The repair's decision (as ``FaceTracker._finish``): where a
        stream of ``take`` holds, the matched full cascade over the ``r``
        streams ``sel``, merged back with their lock flags where ``take``
        holds.  Returns (result, next state)."""
        c = self.cascade

        def repair(res, ok, sel, take):
            sub = self._reordered(c._full(images[sel], image_size),
                                  state.roi[sel], state.valid[sel],
                                  image_size)
            return self._repaired(res, ok, sub, sel, take)

        res, locked = programs.cond(take.any(),
                                    _labelled("track.repair", repair),
                                    lambda res, ok, *_: (res, ok),
                                    (*staged, sel, take))
        return res, self._next_state(res, locked, image_size)

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
