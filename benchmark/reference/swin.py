"""Plain reference of the Swin Transformer forward (arXiv:2103.14030;
``microsoft/Swin-Transformer``'s ``models/swin_transformer.py``:
``PatchEmbed``, ``SwinTransformerBlock``, ``WindowAttention``, ``Mlp``,
``PatchMerging``, ``window_partition``, ``window_reverse``) with
insightface's ``feature`` head over the last stage's tokens, in float32
with TF32 off, from weights under Microsoft's state-dict names
(``swin_weights.npz``).

It writes the published equations with ``F.conv2d``, ``F.layer_norm``,
``F.linear``, ``torch.roll``, one ``qkv`` product split into heads, ``q *
scale``, the relative position bias gathered from each table by an index
built here, the shifted windows' mask built here from the three regions
each way, ``F.gelu``, PatchMerging's channel concatenation of x0..x3 and
``F.batch_norm`` in eval mode, and does not read the converted graph the
program runs:

    x = norm(patch_embed(x).flatten(2).transpose(1, 2))
    for each stage, for each block (shifted by s on the odd ones):
        y = roll(norm1(x).view(B, H, W, C), (-s, -s))
        y = window_reverse(attn(window_partition(y), bias, mask))
        x = x + roll(y, (s, s)).view(B, H * W, C)
        x = x + fc2(gelu(fc1(norm2(x))))
      then PatchMerging, but after the last stage
    x = norm(x).reshape(B, tokens * dim)
    embedding = BN1d(Linear(BN1d(Linear(x))))

Departures from Microsoft's code:

* the input is a crop in (0, 1), mapped to (-1, 1) here as insightface's
  recognizers map pixels (the program's graph holds the map as its first
  MUL and ADD);
* the face head (insightface's ``feature``) replaces the average pool and
  the ImageNet classifier;
* dropout and drop-path are training only: the identity here;
* the sizes are read from the weights (the window and the input side are
  parameters), so the same code runs Swin-S and smaller nets.
"""

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5            # nn.LayerNorm's default
BN_EPS = 2e-5            # feature's BatchNorm1d
MASK = -100.0            # between tokens of different regions


def load(path, device):
    """{name: float32 tensor on ``device``} of ``swin_weights.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def depths_of(w):
    """Blocks a stage, from the weights' names."""
    out = []
    while f"layers.{len(out)}.blocks.0.norm1.weight" in w:
        i = len(out)
        out.append(len({k.split(".")[3] for k in w
                        if k.startswith(f"layers.{i}.blocks.")}))
    return out


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def _bn(w, name, x):
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, BN_EPS)


def window_partition(x, ws):
    """[B * nW, ws, ws, C] windows of a grid [B, H, W, C]."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    """The grid [B, H, W, C] of windows [B * nW, ws, ws, C]."""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws, device="cpu"):
    """[ws*ws, ws*ws] index of each pair of a window's tokens into the
    bias table, as ``WindowAttention.__init__`` builds it."""
    coords = torch.stack(torch.meshgrid(
        [torch.arange(ws, device=device), torch.arange(ws, device=device)],
        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(h, w, ws, shift, device="cpu"):
    """[nW, ws*ws, ws*ws] of 0 and ``MASK``, as
    ``SwinTransformerBlock.__init__`` builds ``attn_mask``."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    windows = window_partition(img, ws).view(-1, ws * ws)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK).masked_fill(mask == 0, 0.0)


def attention(w, p, x, heads, ws, mask=None):
    """``WindowAttention.forward`` of block prefix ``p`` on windows [B_,
    N, C], with the mask [nW, N, N] where given."""
    b, n, c = x.shape
    qkv = F.linear(x, w[f"{p}.attn.qkv.weight"], w[f"{p}.attn.qkv.bias"])
    qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = w[f"{p}.attn.relative_position_bias_table"]
    bias = table[relative_position_index(ws, x.device).view(-1)].view(
        n, n, -1).permute(2, 0, 1).contiguous()
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b // nw, nw, heads, n, n) + mask.unsqueeze(
            1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return F.linear(x, w[f"{p}.attn.proj.weight"], w[f"{p}.attn.proj.bias"])


def block(w, p, x, res, heads, ws, shift):
    """``SwinTransformerBlock.forward`` on tokens [B, res*res, C]: the
    window ``ws`` and ``shift`` as its ``__init__`` sets them."""
    b, length, c = x.shape
    shortcut = x
    x = _ln(w, f"{p}.norm1", x).view(b, res, res, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = shift_mask(res, res, ws, shift, x.device) if shift else None
    windows = attention(w, p, windows, heads, ws, mask).view(-1, ws, ws, c)
    x = window_reverse(windows, ws, res, res)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, res * res, c)
    h = F.linear(_ln(w, f"{p}.norm2", x), w[f"{p}.mlp.fc1.weight"],
                 w[f"{p}.mlp.fc1.bias"])
    return x + F.linear(F.gelu(h), w[f"{p}.mlp.fc2.weight"],
                        w[f"{p}.mlp.fc2.bias"])


def merge(w, p, x, res):
    """``PatchMerging.forward`` on tokens [B, res*res, C]."""
    b, _, c = x.shape
    x = x.view(b, res, res, c)
    x0 = x[:, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, :]
    x3 = x[:, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3], -1).view(b, -1, 4 * c)
    return F.linear(_ln(w, f"{p}.norm", x), w[f"{p}.reduction.weight"])


def forward(w, crops, window):
    """Raw embeddings [N, D] of crops [N, 3, H, W] in (0, 1)."""
    x = (crops - 0.5) / 0.5
    patch = w["patch_embed.proj.weight"].shape[-1]
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=patch)
    res = x.shape[-1]
    x = _ln(w, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    depths = depths_of(w)
    for i, depth in enumerate(depths):
        heads = w[f"layers.{i}.blocks.0.attn."
                  f"relative_position_bias_table"].shape[1]
        ws, shift = window, window // 2
        if res <= window:
            ws, shift = res, 0
        for j in range(depth):
            x = block(w, f"layers.{i}.blocks.{j}", x, res, heads, ws,
                      shift if j % 2 else 0)
        if i + 1 < len(depths):
            x = merge(w, f"layers.{i}.downsample", x, res)
            res //= 2
    x = _ln(w, "norm", x).reshape(x.shape[0], -1)
    x = _bn(w, "feature.1", F.linear(x, w["feature.0.weight"]))
    return _bn(w, "feature.3", F.linear(x, w["feature.2.weight"]))


def embed(w, crops, window, block=32):
    """L2-normalized embeddings [N, D] of crops [N, 3, H, W] in (0, 1),
    ``block`` crops at a time, with TF32 off."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            out = torch.cat([forward(w, crops[i:i + block], window)
                             for i in range(0, crops.shape[0], block)])
            return F.normalize(out, dim=-1, eps=1e-12)
    finally:
        matmul.allow_tf32 = saved
