"""``tpu_face_torch.pipeline.FaceCascade``'s ``warp_method`` on the CPU.

* The constructor's parameters are ``tpu_face.pipeline.FaceCascade``'s,
  in its order, plus a trailing ``device``, so a positional call means
  the same in both packages.
* "gather" runs the plain gather (never the kernels' wrappers), "auto"
  and "pallas" give its result bit for bit on the CPU, and "gather"
  matches ``tpu_face``'s ``FaceCascade(warp_method="gather")`` within
  0.25 px / 1e-3 rad / 1e-3 (tests/test_torch_cascade.py's rules).
* An unknown method (also "MXU": the names are case-sensitive), and
  "separable" (the cascade's ROIs rotate), raise ``ValueError``; "mxu"
  is ported (tests/test_torch_mxu_sample.py holds it against JAX).
"""

import inspect

import pytest
import torch

from test_rotation_e2e import ROT
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.models import FaceDetectionModel
from tpu_face_torch.ops import warp
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

FRAME = "man_rotp30.png"


@pytest.fixture(scope="module")
def frame():
    return load_image(ROT / FRAME)[None]


@pytest.fixture(scope="module")
def gather_result(frame):
    return FaceCascade(warp_method="gather", device="cpu").infer_batch(frame)


def test_parameters_follow_the_reference_order():
    ours = list(inspect.signature(FaceCascade.__init__).parameters)
    ref = list(inspect.signature(JaxFaceCascade.__init__).parameters)
    assert ours == ref + ["device"]
    assert inspect.signature(FaceCascade.__init__).parameters[
        "warp_method"].default == "auto"


def test_positional_call_means_the_reference_arguments():
    cascade = FaceCascade(FaceDetectionModel.BACK_CAMERA, None, torch.float32,
                          "gather", 2, device="cpu")
    assert cascade.max_faces == 2
    assert cascade.warp_method == "gather"
    assert cascade.compute_dtype == torch.float32


def test_gather_calls_no_kernel_wrapper(frame, gather_result, monkeypatch):
    """``warp_method="gather"`` reaches the plain gather on any device: it
    never calls the kernels' dispatcher, so on the card it launches no
    warp kernel."""
    def refuse(*args):
        raise AssertionError("the gather cascade called warp_sample_multi")

    monkeypatch.setattr(warp, "warp_sample_multi", refuse)
    res = FaceCascade(warp_method="gather", device="cpu").infer_batch(frame)
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(gather_result, f)), f


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_kernel_methods_give_the_gather_result_on_the_cpu(
        frame, gather_result, method):
    cascade = FaceCascade(warp_method=method, device="cpu")
    assert cascade.warp_method == ("gather" if method == "auto" else method)
    res = cascade.infer_batch(frame)
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(gather_result, f)), f


def test_gather_matches_jax_gather(frame, gather_result):
    ref = JaxFaceCascade(warp_method="gather").infer_batch(frame)
    _compare(gather_result, ref, (540, 360))


@pytest.mark.parametrize("method,error", [("MXU", ValueError),
                                          ("bogus", ValueError),
                                          ("separable", ValueError)])
def test_unported_or_unknown_methods_raise(method, error):
    with pytest.raises(error):
        FaceCascade(warp_method=method, device="cpu")
