"""tpu_face_torch: the PyTorch/CUDA port of tpu_face's fused cascade.

``tpu_face_torch.pipeline.FaceCascade`` runs detect -> face ROI -> mesh ->
both irises on one CUDA card, with the rotated bilinear ROI warp as a
hand-written CUDA kernel (``csrc/warp_bilinear.cu``).  Module names
follow the JAX package so each counterpart is easy to find.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

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
