"""tpu_face_torch.tracking.MultiFaceTracker on the CPU, step by step
against tpu_face.tracking.MultiFaceTracker.

``MultiFaceTracker(FULL_SPARSE, max_faces=4, redetect_every=2)`` on a
five-step sequence of canvas (c) (the four rotated 540p frames as a 2x2
grid on 1080x720), one quadrant blanked at steps 1 and 2: the stream
loses that face at step 1 and is repaired with three, the redetect at
step 2 keeps three, and the redetect at step 4 finds the fourth again.
Both trackers enter each step with the port's state, and every field
(every slot, in JAX's slot order) is held to tests/test_torch_cascade.py's
rules, with ``tracking`` and ``face_count`` equal.
"""

import numpy as np

import chip_smoke
from test_torch_tracking import _step_both
from tpu_face import tracking as jtrack
from tpu_face.models import FaceDetectionModel as JModel
from tpu_face_torch import tracking as ttrack
from tpu_face_torch.models import FaceDetectionModel as TModel
from tpu_face_torch.utils.image_io import load_image


def _canvas_seq(load):
    """Canvas (c) (the four rotated 540p frames on 1080x720), its third
    quadrant blanked at steps 1 and 2, shifted 2 px right a step."""
    canvas = chip_smoke.canvas_grid(load)
    seq = []
    for step in range(5):
        f = np.roll(canvas, 2 * step, axis=1)
        if step in (1, 2):
            f = f.copy()
            f[360:, :540] = 0
        seq.append(f)
    return seq


def test_multiface_tracker_matches_jax():
    mine = ttrack.MultiFaceTracker(TModel.FULL_SPARSE, max_faces=4,
                                   redetect_every=2, device="cpu")
    ref = jtrack.MultiFaceTracker(JModel.FULL_SPARSE, max_faces=4,
                                  redetect_every=2, warp_method="gather")
    counts = []
    for frame in _canvas_seq(load_image):
        res, want = _step_both(mine, ref, frame[None], (1080, 720))
        np.testing.assert_array_equal(mine.face_count, ref.face_count)
        counts.append(int(mine.face_count[0]))
        # the slots hold the same faces in the same order
        np.testing.assert_array_equal(res.mesh_valid.numpy(),
                                      np.asarray(want.mesh_valid))
    # four faces, three from the step the quadrant goes black (step 1
    # repairs the stream) until the next redetect after it is back
    assert counts == [4, 3, 3, 3, 4], counts
