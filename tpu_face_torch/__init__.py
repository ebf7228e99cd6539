"""tpu_face_torch: the PyTorch/CUDA port of tpu_face.

``tpu_face_torch.pipeline.FaceCascade`` runs detect -> face ROI -> mesh ->
both irises on one CUDA card, with any of the five detectors;
``tpu_face_torch.tracking`` runs it over video (``FaceTracker``,
``MultiFaceTracker``: the detector only when a stream loses its lock),
with optional OneEuro smoothing (``tpu_face_torch.smoothing``);
``tpu_face_torch.pipeline.EmbedCascade`` runs detect -> crop -> embed
(identification);
``tpu_face_torch.models`` has the standalone ``FaceDetection``,
``FaceLandmark``, ``IrisLandmark`` and ``FaceEmbeddings``, each with f32
or bf16 nets (``compute_dtype``); ``tpu_face_torch.compiler`` lowers the
TFLite graphs (``load_model_fn``, ``graph_flops``); ``render`` draws
results, ``utils.profiling`` traces stages on the host and the card,
``utils.native_loader`` decodes JPEG batches on the host, and
``python -m tpu_face_torch`` is the command line.  For serving,
``tpu_face_torch.aot`` saves a cascade's or a tracker's batched program
as a ``torch.export`` artifact and attaches it to a live object, and
``tpu_face_torch.parallel`` splits a batch across CUDA devices
(``infer_sharded``, ``track_sharded``).  The kernels are
hand-written CUDA (``csrc/``): the rotated bilinear ROI warp
(``warp_bilinear.cu``, ``warp_bilinear_strips.cu``, and its
shared-memory staged variants ``warp_strips_staged.cu``) and the
detectors' fused residual blocks (``fused_dw_pw_block.cu`` in f32,
``fused_dw_pw_block_bf16.cu`` in bf16 on the tensor cores); those on the
package's path are registered PyTorch operators
(``torch.ops.tpu_face_torch.*``), so an exported program launches them.
Module names follow the JAX package so each counterpart is easy to
find.

Entry points run on the card unless the caller passes ``device="cpu"``
(the command line: ``--device cpu``); without a card they raise instead
of falling back.
"""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card,
    and asking for one that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_face_torch needs a CUDA device; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def exact_f32():
    """Full-f32 convolutions and matmuls (no TF32) inside the block;
    the previous settings come back after it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


__version__ = "0.3.4"

# the subpackages read resolve_device and exact_f32 from here, so they
# come after them
from . import models, render  # noqa: E402
from .types import BBox, Detection, ImageTensor, Landmark, Rect  # noqa: E402

__all__ = ["BBox", "Detection", "ImageTensor", "Landmark", "Rect",
           "exact_f32", "models", "render", "resolve_device"]
