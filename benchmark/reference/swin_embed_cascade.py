"""Plain reference of the identification cascade with the Swin Transformer:
detect -> crop -> Swin -> L2 norm, in float32 with TF32 off.

Detection, its weighted NMS and the crop are ``reference.embed_cascade``'s
(the int-truncated box sampled by hat-weight matmuls, to the net's 224²);
the net is ``reference.swin``'s forward from the weights under
Microsoft's names, its relative position index and shifted windows' mask
built there, in blocks of 32 crops, a quarter of the program's 128 a
call (cuBLAS runs other shapes on each side: the comparison holds the
program to float32's accuracy, not to one algorithm's rounding).  It
imports nothing of the program.

``run(config, batches, root)`` returns, for each batch, the fields of
``EmbedResult`` with a face axis ([B, K, ...]) as numpy arrays.
"""

import numpy as np
import torch

from models import swin as generator

from . import embed_cascade, swin
from .embed_cascade import FIELDS, NET_BLOCK, crop_boxes


class EmbedCascade(embed_cascade.EmbedCascade):
    """The reference identification cascade of one Swin configuration."""

    def __init__(self, config, root, device, weights):
        # the base loads ``weights`` into {name: tensor}, as ``swin.load``
        super().__init__(config, root, device, weights)
        self.window = int(config["widths"]["window"])

    def __call__(self, frames):
        """Every result field [B, K, ...] of uint8 frames [B, H, W, 3]."""
        b, h, w, _ = frames.shape
        planes, det, score, face_valid = self.detect(frames)
        boxes = crop_boxes(det, (w, h))
        crops = self.crops(planes, boxes)
        emb = swin.embed(self.weights, crops.flatten(0, 1), self.window,
                         NET_BLOCK)
        return {"detection": det, "score": score, "face_valid": face_valid,
                "crop_bbox": boxes, "embedding": emb.reshape(b, self.k, -1)}


def run(config, batches, root, block=32):
    """The reference's results for batches of uint8 frames [B, H, W, 3]
    (on the device it runs on), one {field: numpy array [B, K, ...]} per
    batch, ``block`` frames at a time, with TF32 off.  The net's weights
    are the configuration's seeded ones (``models/swin.py``), written
    beside the program's graph where they are not there yet."""
    weights = generator.model_dir(config, root) / generator.WEIGHTS_FILE
    if not weights.exists():
        generator.write_config(config, root, files=(generator.WEIGHTS_FILE,))
    cascade = EmbedCascade(config, root, batches[0].device, weights)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    results = []
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            for frames in batches:
                parts = {f: [] for f in FIELDS}
                for i in range(0, frames.shape[0], block):
                    out = cascade(frames[i:i + block])
                    for f in FIELDS:
                        parts[f].append(out[f].cpu().numpy())
                results.append({f: np.concatenate(v)
                                for f, v in parts.items()})
    finally:
        matmul.allow_tf32 = saved
    return results
