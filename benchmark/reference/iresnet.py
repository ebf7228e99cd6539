"""Plain reference of ArcFace's IR-ResNet forward (insightface
``recognition/arcface_torch/backbones/iresnet.py``, ``IResNet`` and
``IBasicBlock``; arXiv:1801.07698 §3), in float32 with TF32 off, from
weights under insightface's state-dict names (``iresnet_weights.npz``).

It writes the published equations with ``F.conv2d``, ``F.batch_norm``
in eval mode, ``F.prelu`` and ``F.linear``, and does not read the
converted graph the program runs.  Departures from insightface:

* the input is a crop in (0, 1), mapped to (-1, 1) here as insightface's
  ``(x / 255 - 0.5) / 0.5`` maps pixels (the program's graph holds the
  map as its first MUL and ADD);
* dropout is the identity (inference);
* the unit count per stage is a parameter read from the weights, so the
  same code runs R100 ([3, 13, 30, 3]) and smaller nets.
"""

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5


def load(path, device):
    """{name: float32 tensor on ``device``} of ``iresnet_weights.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def _bn(w, name, x):
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, EPS)


def _unit(w, p, x, stride):
    """``IBasicBlock.forward``: BN, 3x3 conv, BN, PReLU, 3x3 conv (its
    stride), BN, plus the shortcut (a 1x1 strided conv and BN where the
    unit has ``downsample``)."""
    out = _bn(w, f"{p}.bn1", x)
    out = F.conv2d(out, w[f"{p}.conv1.weight"], None, 1, 1)
    out = _bn(w, f"{p}.bn2", out)
    out = F.prelu(out, w[f"{p}.prelu.weight"])
    out = F.conv2d(out, w[f"{p}.conv2.weight"], None, stride, 1)
    out = _bn(w, f"{p}.bn3", out)
    identity = x
    if f"{p}.downsample.0.weight" in w:
        identity = F.conv2d(x, w[f"{p}.downsample.0.weight"], None, stride)
        identity = _bn(w, f"{p}.downsample.1", identity)
    return out + identity


def blocks_of(w):
    """Units per stage, from the weights' names."""
    return [len({k.split(".")[1] for k in w if k.startswith(f"layer{s}.")})
            for s in range(1, 5)]


def forward(w, crops):
    """Raw embeddings [N, D] of crops [N, 3, H, W] in (0, 1)."""
    x = (crops - 0.5) / 0.5
    x = F.conv2d(x, w["conv1.weight"], None, 1, 1)
    x = F.prelu(_bn(w, "bn1", x), w["prelu.weight"])
    for s, n in enumerate(blocks_of(w)):
        for b in range(n):
            # every stage's first unit has stride 2 (``_make_layer``)
            x = _unit(w, f"layer{s + 1}.{b}", x, 2 if b == 0 else 1)
    x = _bn(w, "bn2", x)
    x = torch.flatten(x, 1)
    x = F.linear(x, w["fc.weight"], w["fc.bias"])
    return _bn(w, "features", x)


def embed(w, crops, block=128):
    """L2-normalized embeddings [N, D] of crops [N, 3, H, W] in (0, 1),
    ``block`` crops at a time, with TF32 off."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            out = torch.cat([forward(w, crops[i:i + block])
                             for i in range(0, crops.shape[0], block)])
            return F.normalize(out, dim=-1, eps=1e-12)
    finally:
        matmul.allow_tf32 = saved
