"""tpu_face_torch.aot with the trackers, on the CPU (the counterparts of
tests/test_aot.py's tracker cases): ``FaceTracker`` and
``MultiFaceTracker(max_faces=2)`` saved at two 540x360 streams hold the
programs the step's host branches call ("full" at the step's batch,
"repair" at the repair batch, "tracked"), and a full step, a tracked
step, a repair step (one stream blanked: it loses lock) and a second
repair step (the stream back: the repair locks it again) through the
attached programs match the live tracker (within 1e-6, flags and lock
states equal).  A step at another batch names the saved batch, and
``track_sharded`` refuses the attached tracker.
"""

import numpy as np
import pytest

from test_rotation_e2e import ROT
from test_torch_aot import NAMES, _close
from tpu_face_torch import aot
from tpu_face_torch.parallel import track_sharded
from tpu_face_torch.tracking import FaceTracker, MultiFaceTracker
from tpu_face_torch.utils.image_io import load_image


@pytest.fixture(scope="module")
def frames():
    return np.stack([load_image(ROT / n) for n in NAMES])


def _steps(frames):
    """A full step, a tracked step, a repair step (stream 1 blanked: it
    loses lock and the one-stream repair finds no face) and a second
    repair step (stream 1 back: the repair locks it again)."""
    blank = frames.copy()
    blank[1] = 0
    return [frames, frames[:, :, ::-1].copy(), blank, frames]


@pytest.mark.parametrize("cls,kw", [(FaceTracker, {}),
                                    (MultiFaceTracker, {"max_faces": 2})])
def test_tracker_roundtrip(tmp_path, frames, cls, kw):
    b, h, w, _ = frames.shape
    steps = _steps(frames)
    tracker = cls(warp_method="pallas", device="cpu", **kw)
    live = []
    for x in steps:
        live.append(tracker.step(x))
        live.append(tracker.tracking.copy())
    p = aot.save(cls(warp_method="pallas", device="cpu", **kw),
                 tmp_path / "tracker.aot", batch=b, height=h, width=w)
    fresh = cls(warp_method="pallas", device="cpu", **kw)
    prog = aot.attach(fresh, p)
    assert prog.meta["cls"] == cls.__name__
    # the step's batch and the repair batch (b // 8, at least 1)
    assert sorted(q["name"] for q in prog.meta["programs"]) == [
        "full", "repair", "tracked"]
    for i, x in enumerate(steps):
        _close(live[2 * i], fresh.step(x))
        assert (fresh.tracking == live[2 * i + 1]).all(), i
    assert list(live[5]) == [True, False]     # the blanked stream was lost
    assert fresh.tracking.all()
    with pytest.raises(ValueError, match="saved batch"):
        fresh.step(frames[:1])
    with pytest.raises(ValueError, match="attached artifact"):
        track_sharded(fresh, frames, ["cpu", "cpu"])
