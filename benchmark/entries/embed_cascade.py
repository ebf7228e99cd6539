"""Entry: ``tpu_face_torch.pipeline.EmbedCascade.__call__`` on a batch of
frames on the device, and the comparison of its results with the plain
reference's (``reference/embed_cascade.py``).

The embedding net is the configuration's seeded IR-ResNet
(``models/iresnet.py``): its converted graph, the one file the program
reads, is written at set-up into the checkout's ``build/`` directory
from ``weights_seed`` (so ``setup_s`` counts it); the reference writes
its own file of the same weights after the window.  A call is one
cascade call and the copy of its whole result to the host; on the card
the cascade replays the CUDA graph it captured on its first call at the
geometry.

The comparison reads every field at every sampled frame and face slot:
validity on every slot, the rest on the slots both the reference and the
program find valid, the K slots matched as ``face_cascade`` matches them.
``crop_px`` is the widest gap of the crop boxes' corners in pixels;
``embedding_abs`` the largest gap of a component of the unit-norm
embeddings.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from entries.face_cascade import _match, _pts_px, _worst
from models import iresnet
from reference.embed_cascade import FIELDS

# the checkout the benchmark runs from: the weights go under its build/
ROOT = Path(__file__).resolve().parents[2]
# ``compute_dtype`` of the TF32 control (``calibrate_tf32.py``): the f32
# program with TF32 allowed in the embedding net's convolutions and
# matmuls, the cheap way to make that net several times faster
TF32 = "tfloat32"


def build(config, device):
    """The program under test: the configuration's ``EmbedCascade`` on
    the seeded IR-ResNet, whose files are written first."""
    from tpu_face_torch.models.face_detection import FaceDetectionModel
    from tpu_face_torch.pipeline import EmbedCascade

    path = iresnet.write_config(config, ROOT, files=(iresnet.GRAPH_FILE,))
    dtype = config["compute_dtype"]
    program = EmbedCascade(
        FaceDetectionModel[config["detector"]], embed_model_path=str(path),
        compute_dtype=getattr(torch, "float32" if dtype == TF32 else dtype),
        max_faces=config["max_faces"], warp_method=config["warp_method"],
        device=device)
    net = program._embed_net
    if dtype == TF32:
        program._embed_net = _TF32Net(net)
    print(f"embedding net: {len(net.chains)} epilogue chains, "
          f"{sum(len(c['ops']) - 1 for c in net.chains)} ops absorbed",
          file=sys.stderr, flush=True)
    return program


class _TF32Net(torch.nn.Module):
    """An f32 net with TF32 allowed in its convolutions and matmuls, so
    that the program's capture records TF32 kernels for this net alone."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        matmul = torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                return self.net(x)
        finally:
            matmul.allow_tf32 = saved


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


def compare(got, ref, size):
    """{number: value} of the program's results ``got`` against the
    reference's ``ref`` (both {field: [N, K, ...]}) on frames of ``size``
    (w, h)."""
    w, h = size
    if ref["score"].shape[1] > 1:
        got = _match(got, ref)
    face = ref["face_valid"] & got["face_valid"]
    corners = (np.abs(got["crop_bbox"] - ref["crop_bbox"])).max(-1)
    return {
        "valid_flips": float((ref["face_valid"] != got["face_valid"]).sum()),
        "detection_px": _worst(_pts_px(got["detection"], ref["detection"],
                                       w, h), face),
        "score": _worst(np.abs(got["score"] - ref["score"]), face),
        "crop_px": _worst(corners, face),
        "embedding_abs": _worst(np.abs(got["embedding"]
                                       - ref["embedding"]).max(-1), face),
    }
