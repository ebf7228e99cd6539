"""Entry: ``tpu_face_torch.pipeline.EmbedCascade.__call__`` with
insightface's ViT as the embedding net, and the comparison of its results
with the plain reference's (``reference/vit_embed_cascade.py``).

The embedding net is the configuration's seeded ViT (``models/vit.py``):
its converted graph, the one file the program reads, is written at set-up
into the checkout's ``build/`` directory from ``weights_seed`` (so
``setup_s`` counts it); the reference writes its own file of the same
weights after the window.  The call, its result on the host, the captured
programs, the face axis, the comparison and the TF32 control are
``entries/embed_cascade.py``'s.
"""

import sys
from pathlib import Path

import torch

from entries.embed_cascade import (TF32, _TF32Net, call,  # noqa: F401
                                   compare, programs, with_face_axis)
from models import vit

# the checkout the benchmark runs from: the weights go under its build/
ROOT = Path(__file__).resolve().parents[2]


def build(config, device):
    """The program under test: the configuration's ``EmbedCascade`` on
    the seeded ViT, whose graph is written first."""
    from tpu_face_torch.compiler import lowering
    from tpu_face_torch.models.face_detection import FaceDetectionModel
    from tpu_face_torch.pipeline import EmbedCascade

    if not hasattr(lowering, "ATTENTION"):
        # a port that neither spans a transformer's mechanisms nor frees
        # its dead activations: its traced window cannot hold the ViT
        raise SystemExit("benchmark: this port's lowering recognises no "
                         "attention core; it cannot run a ViT cell")
    path = vit.write_config(config, ROOT, files=(vit.GRAPH_FILE,))
    dtype = config["compute_dtype"]
    program = EmbedCascade(
        FaceDetectionModel[config["detector"]], embed_model_path=str(path),
        compute_dtype=getattr(torch, "float32" if dtype == TF32 else dtype),
        max_faces=config["max_faces"], warp_method=config["warp_method"],
        device=device)
    net = program._embed_net
    if dtype == TF32:
        program._embed_net = _TF32Net(net)
    print(f"embedding net: {len(net.attention_cores)} attention cores, "
          f"{len(net.layer_norms)} LayerNorms", file=sys.stderr, flush=True)
    return program
