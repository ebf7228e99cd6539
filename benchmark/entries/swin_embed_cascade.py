"""Entry: ``tpu_face_torch.pipeline.EmbedCascade.__call__`` with the Swin
Transformer as the embedding net, and the comparison of its results with
the plain reference's (``reference/swin_embed_cascade.py``).

The embedding net is the configuration's seeded Swin (``models/swin.py``):
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
from models import swin

# the checkout the benchmark runs from: the weights go under its build/
ROOT = Path(__file__).resolve().parents[2]
# the ops of a shifted-window transformer's graph that a port's lowering
# may lack: the cyclic shift's halves and the MLP's activation
NEEDS = ("SLICE", "GELU")


def build(config, device):
    """The program under test: the configuration's ``EmbedCascade`` on
    the seeded Swin, whose graph is written first."""
    from tpu_face_torch.compiler import lowering
    from tpu_face_torch.models.face_detection import FaceDetectionModel
    from tpu_face_torch.pipeline import EmbedCascade

    missing = [op for op in NEEDS if op not in lowering._SUPPORTED]
    if missing:
        raise SystemExit(f"benchmark: this port's lowering has no "
                         f"{', '.join(missing)}; it cannot run a Swin cell")
    path = swin.write_config(config, ROOT, files=(swin.GRAPH_FILE,))
    dtype = config["compute_dtype"]
    program = EmbedCascade(
        FaceDetectionModel[config["detector"]], embed_model_path=str(path),
        compute_dtype=getattr(torch, "float32" if dtype == TF32 else dtype),
        max_faces=config["max_faces"], warp_method=config["warp_method"],
        device=device)
    net = program._embed_net
    if dtype == TF32:
        program._embed_net = _TF32Net(net)
    print(f"embedding net: {len(net.attention_cores)} attention cores "
          f"({len(net.masked_cores)} masked), {len(net.layer_norms)} "
          f"LayerNorms, {len(net.window_ops)} window spans, "
          f"{len(net.tc_fcs)} FCs on fc_tc", file=sys.stderr, flush=True)
    return program
