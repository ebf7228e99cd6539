"""Entry: ``tpu_face_torch.pipeline.FaceCascade.__call__`` on a batch of
frames on the device, and the comparison of its results with the plain
reference's (``reference/cascade.py``).

A call is one cascade call and the copy of its whole result to the host;
on the card the cascade replays the CUDA graph it captured on its first
call at the geometry.  The comparison reads every field of the result at
every sampled frame and face slot: validity on every slot, the rest on
the slots the reference and the program both find valid (the mesh, eye
ROIs and irises where both find the mesh valid), in pixels of the frame.
The mesh's presence score is held by its validity alone: for the faces
of these mixes it saturates at 1.0 in float32, so its gap reads 0 in
the program and in the lower-precision control alike.
With several faces a frame, the program's slots are matched to the
reference's by the permutation that puts their boxes closest, since two
faces whose scores agree to rounding may come out in either order.
"""

import itertools
import math

import numpy as np
import torch

from reference.cascade import FIELDS


def build(config, device):
    """The program under test: the configuration's ``FaceCascade``."""
    from tpu_face_torch.models.face_detection import FaceDetectionModel
    from tpu_face_torch.pipeline import FaceCascade

    return FaceCascade(FaceDetectionModel[config["detector"]],
                       compute_dtype=getattr(torch, config["compute_dtype"]),
                       max_faces=config["max_faces"],
                       warp_method=config["warp_method"], device=device)


def call(program, batch, done=None):
    """One call and its whole result on the host: {field: CPU tensor}.
    ``done``, a CUDA event where given, is recorded on the stream once the
    call's work and copies are queued, before the wait for them."""
    res = program(batch)
    host = {f: getattr(res, f).to("cpu", non_blocking=True) for f in FIELDS}
    if done is not None:
        done.record(torch.cuda.current_stream(batch.device))
    if batch.is_cuda:
        torch.cuda.current_stream(batch.device).synchronize()
    return host


def programs(program):
    """[(name, capture s, pool bytes)] of the cascade's captured graphs."""
    cache = getattr(program, "_cache", None)
    return [(str(key[0]), p.capture_s, p.nbytes)
            for key, p in getattr(cache, "entries", {}).items()]


def with_face_axis(result, max_faces):
    """{field: numpy [B, K, ...]}: a ``max_faces=1`` result gains its face
    axis."""
    out = {}
    for f in FIELDS:
        a = np.asarray(result[f])
        out[f] = a[:, None] if max_faces == 1 else a
    return out


def _match(got, ref):
    """The program's slots permuted to the reference's: per frame the
    permutation of the K slots that minimizes the summed pixel distance
    of valid boxes' centres (a validity disagreement costs more than any
    distance)."""
    k = ref["score"].shape[1]
    c_ref = ref["detection"][:, :, :2].mean(2)          # [N, K, 2]
    c_got = got["detection"][:, :, :2].mean(2)
    dist = np.abs(c_ref[:, :, None] - c_got[:, None]).sum(-1)  # [N, K, K]
    v_ref, v_got = ref["face_valid"], got["face_valid"]
    cost = np.where(v_ref[:, :, None] & v_got[:, None], dist, 0.0)
    cost = cost + 1e6 * (v_ref[:, :, None] != v_got[:, None])
    perms = np.array(list(itertools.permutations(range(k))))  # [P, K]
    total = cost[:, np.arange(k)[None], perms].sum(-1)        # [N, P]
    best = perms[np.argmin(total, 1)]                          # [N, K]
    out = {}
    for f, a in got.items():
        idx = best.reshape(best.shape + (1,) * (a.ndim - 2))
        out[f] = np.take_along_axis(a, idx, 1)
    return out


def _roi_px(a, b, w, h):
    """Widest gap of ROIs [..., 5] in pixels: centre and size, and the
    rotation's gap as the move of a corner of the reference ROI."""
    scale = np.array([w, h, w, h])
    gap = np.abs(a[..., :4] - b[..., :4]) * scale
    rot = np.abs((a[..., 4] - b[..., 4] + math.pi) % (2 * math.pi) - math.pi)
    half = np.maximum(b[..., 2] * w, b[..., 3] * h) / 2.0
    return np.maximum(gap.max(-1), rot * half)


def _pts_px(a, b, w, h):
    """Widest gap of points [..., 2 or 3] in pixels (z at the width's
    scale, as the landmarks carry it)."""
    scale = np.array([w, h, w][:a.shape[-1]])
    return (np.abs(a - b) * scale).max(-1)


def _worst(gaps, mask):
    """The widest of ``gaps`` [N, K, ...] over the slots in ``mask``."""
    m = np.broadcast_to(mask.reshape(mask.shape + (1,) * (gaps.ndim - 2)),
                        gaps.shape)
    return float(gaps[m].max()) if m.any() else 0.0


def compare(got, ref, size):
    """{number: value} of the program's results ``got`` against the
    reference's ``ref`` (both {field: [N, K, ...]}) on frames of ``size``
    (w, h)."""
    w, h = size
    if ref["score"].shape[1] > 1:
        got = _match(got, ref)
    face = ref["face_valid"] & got["face_valid"]
    mesh = ref["mesh_valid"] & got["mesh_valid"]
    return {
        "valid_flips": float(
            (ref["face_valid"] != got["face_valid"]).sum()
            + (ref["mesh_valid"] != got["mesh_valid"]).sum()),
        "detection_px": _worst(_pts_px(got["detection"], ref["detection"],
                                       w, h), face),
        "score": _worst(np.abs(got["score"] - ref["score"]), face),
        "face_roi_px": _worst(_roi_px(got["face_roi"], ref["face_roi"], w, h),
                              face),
        "mesh_raw_px": _worst(_pts_px(got["mesh_raw"], ref["mesh_raw"], w, h),
                              mesh),
        "eye_rois_px": _worst(_roi_px(got["eye_rois"], ref["eye_rois"], w, h),
                              mesh),
        "iris_px": _worst(_pts_px(got["iris"], ref["iris"], w, h), mesh),
        "mesh_px": _worst(_pts_px(got["mesh"], ref["mesh"], w, h), mesh),
    }
