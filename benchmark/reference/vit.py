"""Plain reference of insightface's face-recognition ViT forward
(``recognition/arcface_torch/backbones/vit.py``: ``VisionTransformer``,
``Block``, ``Attention``, ``Mlp``; arXiv:2010.11929), in float32 with TF32
off, from weights under insightface's state-dict names
(``vit_weights.npz``).

It writes the published equations with ``F.conv2d``, ``F.layer_norm``,
``F.linear``, an explicit ``softmax(q @ k^T * head_dim^-1/2) @ v`` over
heads split from ``qkv``'s one product, ``F.relu6`` and ``F.batch_norm``
in eval mode, and does not read the converted graph the program runs:

    x = patch_embed(x).flatten(2).transpose(1, 2) + pos_embed
    for each block:  x = x + proj(attn(norm1(x)))
                     x = x + fc2(relu6(fc1(norm2(x))))
    x = norm(x).reshape(B, tokens * dim)
    embedding = BN1d(Linear(BN1d(Linear(x))))

Departures from insightface:

* the input is a crop in (0, 1), mapped to (-1, 1) here as insightface's
  ``(x / 255 - 0.5) / 0.5`` maps pixels (the program's graph holds the
  map as its first MUL and ADD);
* every product in float32: insightface runs ``qkv``, ``proj`` and the
  MLP under fp16 autocast (its attention core in float32);
* dropout, drop-path and ``mask_ratio``'s random masking are training
  only: the identity here;
* depth, width and patch are read from the weights and the head count is
  a parameter, so the same code runs ViT-L and smaller nets.
"""

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5            # nn.LayerNorm's default
BN_EPS = 2e-5            # feature's BatchNorm1d


def load(path, device):
    """{name: float32 tensor on ``device``} of ``vit_weights.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def depth_of(w):
    """Blocks, from the weights' names."""
    return len({k.split(".")[1] for k in w if k.startswith("blocks.")})


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def _bn(w, name, x):
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, BN_EPS)


def attention(w, p, x, heads):
    """``Attention.forward`` of block prefix ``p`` on tokens [B, N, C]."""
    b, n, c = x.shape
    qkv = F.linear(x, w[f"{p}.attn.qkv.weight"])
    qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q @ k.transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return F.linear(x, w[f"{p}.attn.proj.weight"], w[f"{p}.attn.proj.bias"])


def block(w, p, x, heads):
    """``Block.forward``: x + attn(norm1(x)), then x + mlp(norm2(x))."""
    x = x + attention(w, p, _ln(w, f"{p}.norm1", x), heads)
    h = F.linear(_ln(w, f"{p}.norm2", x), w[f"{p}.mlp.fc1.weight"],
                 w[f"{p}.mlp.fc1.bias"])
    return x + F.linear(F.relu6(h), w[f"{p}.mlp.fc2.weight"],
                        w[f"{p}.mlp.fc2.bias"])


def forward(w, crops, heads):
    """Raw embeddings [N, D] of crops [N, 3, H, W] in (0, 1)."""
    x = (crops - 0.5) / 0.5
    patch = w["patch_embed.proj.weight"].shape[-1]
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=patch)
    x = x.flatten(2).transpose(1, 2) + w["pos_embed"]
    for i in range(depth_of(w)):
        x = block(w, f"blocks.{i}", x, heads)
    x = _ln(w, "norm", x).reshape(x.shape[0], -1)
    x = _bn(w, "feature.1", F.linear(x, w["feature.0.weight"]))
    return _bn(w, "feature.3", F.linear(x, w["feature.2.weight"]))


def embed(w, crops, heads, block=32):
    """L2-normalized embeddings [N, D] of crops [N, 3, H, W] in (0, 1),
    ``block`` crops at a time, with TF32 off."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            out = torch.cat([forward(w, crops[i:i + block], heads)
                             for i in range(0, crops.shape[0], block)])
            return F.normalize(out, dim=-1, eps=1e-12)
    finally:
        matmul.allow_tf32 = saved
