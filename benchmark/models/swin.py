"""The Swin Transformer (arXiv:2103.14030; ``microsoft/Swin-Transformer``'s
``models/swin_transformer.py``: ``SwinTransformer``, ``PatchEmbed``,
``BasicLayer``, ``SwinTransformerBlock``, ``WindowAttention``, ``Mlp`` and
``PatchMerging``) as a face recognizer, with insightface's ``feature``
head over its last stage's tokens in place of the ImageNet classifier
(as JDAI-CV's FaceX-Zoo trains Swin backbones for faces), with seeded
weights, written as two files into a directory:

* ``face_embeddings.npz``: the net as a converted TFLite graph, in the
  schema of ``tools/convert_tflite.py``: the input map (0, 1) -> (-1, 1)
  as a MUL and an ADD; the patch embedding a VALID CONV_2D of stride and
  window ``patch``, a RESHAPE to [1, tokens, dim] (row-major over the
  patch grid) and its LayerNorm; each LayerNorm decomposed as in
  ``models/vit.py``; per block: LN1, a RESHAPE to the token grid [1, H,
  W, C], on the shifted blocks the cyclic shift by (-s, -s) (each axis a
  CONCATENATION of two SLICEs: ``torch.roll`` as the converter writes
  it), the window partition (a RESHAPE to [1, H/w, w, W/w, w, C], the
  TRANSPOSE (0, 1, 3, 2, 4, 5), a RESHAPE to [-1, w*w, C]: the windows of
  every image on the leading axis), q, k and v as three
  FULLY_CONNECTED with their biases, the head split, BATCH_MATMUL
  (``adj_y``), the scale as a MUL on the scores, the relative position
  bias an ADD of the gathered table [heads, w*w, w*w], on the shifted
  blocks a RESHAPE to [-1, windows, heads, w*w, w*w], the ADD of the
  regions' mask [1, windows, 1, w*w, w*w] (-100 between tokens from
  different regions) and a RESHAPE back, SOFTMAX, BATCH_MATMUL, the head
  merge, ``proj``, the window reverse (the same three ops the other way),
  the shift back by (s, s), a RESHAPE to the tokens and the residual ADD;
  then LN2, ``fc1``, GELU (exact), ``fc2`` and the residual ADD; each
  PatchMerging a RESHAPE to [1, H/2, 2, W/2, 2, C], the TRANSPOSE (0, 1,
  3, 4, 2, 5) (the 4C channels in Swin's order x0, x1, x2, x3: the column
  offset major, the row offset minor), a RESHAPE to [1, HW/4, 4C], its
  LayerNorm and a bias-free FULLY_CONNECTED; the final LayerNorm, the
  flatten a RESHAPE to [1, tokens * dim], and the two ``feature`` Linears
  with their BatchNorm1d folded into weights and a bias.  Output: the raw
  512-d embedding.
* ``swin_weights.npz``: the same weights unfolded, under Microsoft's
  state-dict names (``feature.*`` for the head, insightface's), for a
  plain reference of the published equations.

Departures from the converter: ``qkv`` is three FULLY_CONNECTED over its
row blocks q, k and v, each read by its own head split (the op set has no
SPLIT), and the scale multiplies the scores, not q (Swin's code scales q:
the same in exact arithmetic).  Stage by stage the window is the smaller
of ``window`` and the token grid's side, and a stage whose grid is no
larger than the window has no shift, as Swin's code sets them (Swin-S's
last stage, 7 x 7).

Plain numpy: no TensorFlow, no torch.  The same seed and sizes give the
same bytes: ``write(out_dir, seed)``.

Weights (no trained Swin is in the repository): drawn so each mechanism
does real work.  The patch embedding and the value, MLP and merge
products keep unit variance; q and k are drawn so that a head's logits
``q.k / sqrt(head_dim)`` have a standard deviation near 2 (a peaked
softmax over the window); each relative position bias table has a
standard deviation near 1, so a wrong index or a transposed table moves
the embedding; ``proj`` and ``fc2`` are scaled so each residual branch
adds a variance near 0.04; ``fc1``'s pre-activations have a standard
deviation near 2; each BatchNorm1d's running statistics are drawn around
the unit variance its input has.
"""

import json
from pathlib import Path

import numpy as np

from .iresnet import model_dir, save_npz
from .vit import _Writer as _VitWriter

# swin_small_patch4_window7_224.yaml (Table 1 of arXiv:2103.14030): input
# side, patch, first stage's width, blocks and heads a stage, window, MLP
# ratio; the face head's embedding width
PUBLISHED = {"input": 224, "patch": 4, "dim": 96, "depths": (2, 2, 18, 2),
             "heads": (3, 6, 12, 24), "window": 7, "mlp_ratio": 4,
             "embedding": 512}
GRAPH_FILE = "face_embeddings.npz"
WEIGHTS_FILE = "swin_weights.npz"
# Swin's mask between tokens of different regions of a shifted window
MASK = -100.0
# a head's logits' standard deviation, the relative position bias's, the
# residual branches' variance, fc1's pre-activations' standard deviation
LOGIT_STD = 2.0
BIAS_STD = 1.0
BRANCH_VAR = 0.04
FC1_STD = 2.0


def _sizes(**given):
    """The published sizes, updated by the ``given`` ones that are set."""
    return dict(PUBLISHED, **{k: v for k, v in given.items()
                              if v is not None})


def stages(input, patch, dim, depths, heads, window, **_):
    """Per stage, {"res": grid side, "dim", "depth", "heads", "window",
    "shift"}: the window is no larger than the grid, and a grid no larger
    than the window has no shift."""
    out = []
    res = input // patch
    for i, (depth, h) in enumerate(zip(depths, heads)):
        out.append({"res": res, "dim": dim * 2 ** i, "depth": depth,
                    "heads": h, "window": min(window, res),
                    "shift": 0 if res <= window else window // 2})
        res //= 2
    return out


def param_shapes(input, patch, dim, depths, heads, window, mlp_ratio,
                 embedding):
    """{Microsoft's name (``feature.*``: insightface's): shape} of every
    tensor of the state dict."""
    shapes = {"patch_embed.proj.weight": (dim, 3, patch, patch),
              "patch_embed.proj.bias": (dim,),
              "patch_embed.norm.weight": (dim,),
              "patch_embed.norm.bias": (dim,)}
    st = stages(input, patch, dim, depths, heads, window)
    for i, s in enumerate(st):
        c, w = s["dim"], s["window"]
        for j in range(s["depth"]):
            p = f"layers.{i}.blocks.{j}"
            for norm in ("norm1", "norm2"):
                shapes[f"{p}.{norm}.weight"] = (c,)
                shapes[f"{p}.{norm}.bias"] = (c,)
            shapes[f"{p}.attn.qkv.weight"] = (3 * c, c)
            shapes[f"{p}.attn.qkv.bias"] = (3 * c,)
            shapes[f"{p}.attn.relative_position_bias_table"] = (
                (2 * w - 1) ** 2, s["heads"])
            shapes[f"{p}.attn.proj.weight"] = (c, c)
            shapes[f"{p}.attn.proj.bias"] = (c,)
            shapes[f"{p}.mlp.fc1.weight"] = (mlp_ratio * c, c)
            shapes[f"{p}.mlp.fc1.bias"] = (mlp_ratio * c,)
            shapes[f"{p}.mlp.fc2.weight"] = (c, mlp_ratio * c)
            shapes[f"{p}.mlp.fc2.bias"] = (c,)
        if i + 1 < len(st):
            p = f"layers.{i}.downsample"
            shapes[f"{p}.norm.weight"] = shapes[f"{p}.norm.bias"] = (4 * c,)
            shapes[f"{p}.reduction.weight"] = (2 * c, 4 * c)
    last = st[-1]
    c = last["dim"]
    shapes["norm.weight"] = shapes["norm.bias"] = (c,)
    shapes["feature.0.weight"] = (c, last["res"] ** 2 * c)
    shapes["feature.2.weight"] = (embedding, c)
    for bn, n in (("feature.1", c), ("feature.3", embedding)):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{k}"] = (n,)
    return shapes


def parameters(shapes):
    """Trainable parameters among ``shapes`` (BN running statistics are
    buffers)."""
    return sum(int(np.prod(s)) for k, s in shapes.items()
               if "running" not in k)


def draw_weights(seed, input, patch, dim, depths, heads, window, mlp_ratio,
                 embedding):
    """{name: float32 array} of a Swin of these sizes, from ``seed``."""
    rng = np.random.default_rng(seed)
    st = stages(input, patch, dim, depths, heads, window)
    for s in st:
        if s["dim"] % s["heads"] or s["res"] % s["window"]:
            raise ValueError(f"stage {s}: width no multiple of its heads or "
                             f"grid no multiple of its window")
    shapes = param_shapes(input, patch, dim, depths, heads, window,
                          mlp_ratio, embedding)

    def normal(name, std):
        x = rng.standard_normal(shapes[name], dtype=np.float32)
        x *= np.float32(std)
        return x

    def uniform(name, lo, hi):
        return rng.uniform(lo, hi, shapes[name]).astype(np.float32)

    def norm(name):
        w[f"{name}.weight"] = uniform(f"{name}.weight", 0.8, 1.2)
        w[f"{name}.bias"] = normal(f"{name}.bias", 0.05)

    w = {}
    # inputs in (-1, 1), about a third of unit variance a pixel: the
    # tokens near unit variance before their LayerNorm
    w["patch_embed.proj.weight"] = normal("patch_embed.proj.weight",
                                          np.sqrt(3.0 / (3 * patch * patch)))
    w["patch_embed.proj.bias"] = normal("patch_embed.proj.bias", 0.02)
    norm("patch_embed.norm")
    for i, s in enumerate(st):
        c = s["dim"]
        # q.k / sqrt(head_dim) over head_dim products of unit-variance LN
        # outputs has variance (c * var_qk)^2: LOGIT_STD from var_qk
        qk_std = np.sqrt(LOGIT_STD / c)
        hidden = mlp_ratio * c
        for j in range(s["depth"]):
            p = f"layers.{i}.blocks.{j}"
            norm(f"{p}.norm1")
            qkv = rng.standard_normal(shapes[f"{p}.attn.qkv.weight"],
                                      dtype=np.float32)
            qkv[:2 * c] *= np.float32(qk_std)
            qkv[2 * c:] *= np.float32(np.sqrt(1.0 / c))
            w[f"{p}.attn.qkv.weight"] = qkv
            w[f"{p}.attn.qkv.bias"] = normal(f"{p}.attn.qkv.bias", 0.02)
            table = f"{p}.attn.relative_position_bias_table"
            w[table] = normal(table, BIAS_STD)
            # values of unit variance: proj's output has BRANCH_VAR
            w[f"{p}.attn.proj.weight"] = normal(f"{p}.attn.proj.weight",
                                                np.sqrt(BRANCH_VAR / c))
            w[f"{p}.attn.proj.bias"] = normal(f"{p}.attn.proj.bias", 0.02)
            norm(f"{p}.norm2")
            w[f"{p}.mlp.fc1.weight"] = normal(f"{p}.mlp.fc1.weight",
                                              FC1_STD / np.sqrt(c))
            w[f"{p}.mlp.fc1.bias"] = normal(f"{p}.mlp.fc1.bias", 0.05)
            # GELU of N(0, FC1_STD^2) has a second moment near
            # FC1_STD^2 / 2 (1.93 at 2)
            w[f"{p}.mlp.fc2.weight"] = normal(
                f"{p}.mlp.fc2.weight",
                np.sqrt(BRANCH_VAR / (hidden * FC1_STD ** 2 / 2)))
            w[f"{p}.mlp.fc2.bias"] = normal(f"{p}.mlp.fc2.bias", 0.02)
        if i + 1 < len(st):
            p = f"layers.{i}.downsample"
            norm(f"{p}.norm")
            w[f"{p}.reduction.weight"] = normal(f"{p}.reduction.weight",
                                                np.sqrt(1.0 / (4 * c)))
    norm("norm")
    flat = shapes["feature.0.weight"][1]
    c = st[-1]["dim"]
    w["feature.0.weight"] = normal("feature.0.weight", np.sqrt(1.0 / flat))
    w["feature.2.weight"] = normal("feature.2.weight", np.sqrt(1.0 / c))
    # each BatchNorm1d sees about unit variance (its Linear keeps it)
    for bn in ("feature.1", "feature.3"):
        w[f"{bn}.weight"] = uniform(f"{bn}.weight", 0.8, 1.2)
        w[f"{bn}.bias"] = normal(f"{bn}.bias", 0.05)
        w[f"{bn}.running_mean"] = normal(f"{bn}.running_mean", 0.05)
        w[f"{bn}.running_var"] = uniform(f"{bn}.running_var", 0.8, 1.25)
    return w


def relative_position_index(window):
    """[w*w, w*w] index into a (2w - 1)^2-row bias table of each pair of
    a window's tokens (row-major), as ``WindowAttention`` builds it."""
    hh, ww = np.meshgrid(np.arange(window), np.arange(window),
                         indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)])       # [2, N]
    rel = coords[:, :, None] - coords[:, None, :]             # [2, N, N]
    return (rel[0] + window - 1) * (2 * window - 1) + rel[1] + window - 1


def region_mask(res, window, shift):
    """[windows, w*w, w*w] of 0 and ``MASK``: after the cyclic shift, the
    tokens of a window that came from different regions of the grid (three
    bands each way: 0:-w, -w:-s, -s:) do not attend to each other."""
    band = np.zeros(res, np.int64)
    band[res - window:res - shift] = 1
    band[res - shift:] = 2
    region = band[:, None] * 3 + band[None, :]                # [res, res]
    n = res // window
    windows = region.reshape(n, window, n, window).transpose(
        0, 2, 1, 3).reshape(n * n, window * window)
    return np.where(windows[:, :, None] != windows[:, None, :], MASK,
                    0.0).astype(np.float32)


class _Writer(_VitWriter):
    """The Swin's ops in the converter's schema, from weights ``w`` under
    Microsoft's names."""

    def __init__(self, w):
        super().__init__(w, None)

    def reshape(self, x, shape, target, name):
        """RESHAPE of ``x`` to ``target`` (a leading -1: the windows of
        every image), its tensor in the graph's batch-1 ``shape``."""
        return self.op("RESHAPE", [x, self.const(np.array(
            target, np.int32), f"{name}/shape")], shape, name)

    def transpose(self, x, shape, perm, name):
        return self.op("TRANSPOSE", [x, self.const(np.array(
            perm, np.int32), f"{name}/perm")], shape, name)

    def roll(self, x, shape, shift, name):
        """``torch.roll(x, (shift, shift), (1, 2))`` of a token grid [1, H,
        W, C]: along each axis a CONCATENATION of the two SLICEs."""
        for axis in (1, 2):
            n = shape[axis]
            s = -shift % n
            parts = []
            for k, (begin, size) in enumerate(((s, n - s), (0, s))):
                b, z = [0] * 4, [-1] * 4
                b[axis], z[axis] = begin, size
                part = list(shape)
                part[axis] = size
                parts.append(self.op("SLICE", [x, self.const(
                    np.array(b, np.int32), f"{name}/{axis}{k}/begin"),
                    self.const(np.array(z, np.int32),
                               f"{name}/{axis}{k}/size")], part,
                    f"{name}/{axis}{k}"))
            x = self.op("CONCATENATION", parts, list(shape),
                        f"{name}/{axis}", axis=axis, activation="NONE")
        return x

    def attention(self, x, s, p, windows):
        """``WindowAttention`` on windows [nW, N, C], the shifted windows'
        mask where the block shifts."""
        c, h, win = s["dim"], s["heads"], s["window"]
        n, hd = win * win, s["dim"] // s["heads"]
        qkv = self.w[f"{p}.attn.qkv.weight"]
        qkv_b = self.w[f"{p}.attn.qkv.bias"]
        parts = [self.fc(x, [windows, n, c], qkv[j * c:(j + 1) * c],
                         qkv_b[j * c:(j + 1) * c], name=f"{p}.attn.{t}")
                 for j, t in enumerate("qkv")]
        q, k, v = (self.transpose(
            self.reshape(t, [windows, n, h, hd], [-1, n, h, hd],
                         f"{p}.attn.{name}/heads"),
            [windows, h, n, hd], [0, 2, 1, 3], f"{p}.attn.{name}/transpose")
            for t, name in zip(parts, "qkv"))
        scores = [windows, h, n, n]
        a = self.op("BATCH_MATMUL", [q, k], scores, f"{p}.attn/scores",
                    adj_x=False, adj_y=True)
        a = self.op("MUL", [a, self.const(np.array(hd ** -0.5, np.float32),
                                          f"{p}.attn/scale")],
                    scores, f"{p}.attn/scaled", activation="NONE")
        table = self.w[f"{p}.attn.relative_position_bias_table"]
        bias = table[relative_position_index(win).reshape(-1)].reshape(
            n, n, h).transpose(2, 0, 1)
        a = self.op("ADD", [a, self.const(np.ascontiguousarray(bias),
                                          f"{p}.attn/bias")],
                    scores, f"{p}.attn/biased", activation="NONE")
        if s["shift"]:
            per_image = [1, windows, h, n, n]
            a = self.reshape(a, per_image, [-1, windows, h, n, n],
                             f"{p}.attn/per_image")
            mask = region_mask(s["res"], win, s["shift"])[None, :, None]
            a = self.op("ADD", [a, self.const(mask, f"{p}.attn/mask")],
                        per_image, f"{p}.attn/masked", activation="NONE")
            a = self.reshape(a, scores, [-1, h, n, n], f"{p}.attn/windows")
        a = self.op("SOFTMAX", [a], scores, f"{p}.attn/softmax", beta=1.0)
        y = self.op("BATCH_MATMUL", [a, v], [windows, h, n, hd],
                    f"{p}.attn/context", adj_x=False, adj_y=False)
        y = self.transpose(y, [windows, n, h, hd], [0, 2, 1, 3],
                           f"{p}.attn/merge")
        y = self.reshape(y, [windows, n, c], [-1, n, c], f"{p}.attn/merged")
        return self.fc(y, [windows, n, c], self.w[f"{p}.attn.proj.weight"],
                       self.w[f"{p}.attn.proj.bias"], f"{p}.attn.proj")

    def block(self, x, s, p, shift):
        """``SwinTransformerBlock`` on tokens [1, H*W, C]: x + the windowed
        attention of LN1(x) (shifted by ``shift``), then x +
        fc2(GELU(fc1(LN2(x))))."""
        res, c, win = s["res"], s["dim"], s["window"]
        tokens, grid = [1, res * res, c], [1, res, res, c]
        per = res // win
        windows = per * per
        y = self.layer_norm(x, tokens, f"{p}.norm1")
        y = self.reshape(y, grid, grid, f"{p}/grid")
        if shift:
            y = self.roll(y, grid, -shift, f"{p}/shift")
        y = self.reshape(y, [1, per, win, per, win, c],
                         [1, per, win, per, win, c], f"{p}/partition")
        y = self.transpose(y, [1, per, per, win, win, c],
                           [0, 1, 3, 2, 4, 5], f"{p}/partition/windows")
        y = self.reshape(y, [windows, win * win, c], [-1, win * win, c],
                         f"{p}/partition/tokens")
        y = self.attention(y, dict(s, shift=shift), p, windows)
        y = self.reshape(y, [1, per, per, win, win, c],
                         [-1, per, per, win, win, c], f"{p}/reverse")
        y = self.transpose(y, [1, per, win, per, win, c],
                           [0, 1, 3, 2, 4, 5], f"{p}/reverse/grid")
        y = self.reshape(y, grid, [-1, res, res, c], f"{p}/reverse/rows")
        if shift:
            y = self.roll(y, grid, shift, f"{p}/unshift")
        y = self.reshape(y, tokens, [-1, res * res, c], f"{p}/tokens")
        x = self.op("ADD", [x, y], tokens, f"{p}.attn/residual",
                    activation="NONE")
        y = self.layer_norm(x, tokens, f"{p}.norm2")
        hidden = self.w[f"{p}.mlp.fc1.weight"].shape[0]
        y = self.fc(y, [1, res * res, hidden], self.w[f"{p}.mlp.fc1.weight"],
                    self.w[f"{p}.mlp.fc1.bias"], f"{p}.mlp.fc1")
        y = self.op("GELU", [y], [1, res * res, hidden], f"{p}.mlp/gelu",
                    approximate=False)
        y = self.fc(y, tokens, self.w[f"{p}.mlp.fc2.weight"],
                    self.w[f"{p}.mlp.fc2.bias"], f"{p}.mlp.fc2")
        return self.op("ADD", [x, y], tokens, f"{p}.mlp/residual",
                       activation="NONE")

    def merge(self, x, s, p):
        """``PatchMerging``: each 2x2 of the grid's tokens concatenated
        (x0, x1, x2, x3), LayerNorm, the bias-free reduction to 2C."""
        half, c = s["res"] // 2, s["dim"]
        x = self.reshape(x, [1, half, 2, half, 2, c],
                         [1, half, 2, half, 2, c], f"{p}/grid")
        x = self.transpose(x, [1, half, half, 2, 2, c], [0, 1, 3, 4, 2, 5],
                           f"{p}/gather")
        shape = [1, half * half, 4 * c]
        x = self.reshape(x, shape, shape, f"{p}/concat")
        x = self.layer_norm(x, shape, f"{p}.norm")
        return self.fc(x, [1, half * half, 2 * c],
                       self.w[f"{p}.reduction.weight"], name=f"{p}.reduction")


def _stages_of(w, input, window):
    """``stages`` of the net whose weights are ``w``."""
    dim, _, patch, _ = w["patch_embed.proj.weight"].shape
    depths, heads = [], []
    i = 0
    while f"layers.{i}.blocks.0.norm1.weight" in w:
        depths.append(len({k.split(".")[3] for k in w
                           if k.startswith(f"layers.{i}.blocks.")}))
        heads.append(w[f"layers.{i}.blocks.0.attn."
                       f"relative_position_bias_table"].shape[1])
        i += 1
    return stages(input, patch, dim, depths, heads, window)


def graph_from_weights(w, size, window):
    """(graph JSON dict, {"t<id>": constant}) of the converted net on
    inputs of ``size``²."""
    g = _Writer(w)
    st = _stages_of(w, size, window)
    dim, _, patch, _ = w["patch_embed.proj.weight"].shape
    side = size // patch
    x = inputs = g.tensor([1, size, size, 3], "input")
    x = g.op("MUL", [x, g.const(np.array(2.0, np.float32), "in_scale")],
             [1, size, size, 3], "input_map/mul", activation="NONE")
    x = g.op("ADD", [x, g.const(np.array(-1.0, np.float32), "in_shift")],
             [1, size, size, 3], "input_map/add", activation="NONE")
    conv = np.ascontiguousarray(
        w["patch_embed.proj.weight"].transpose(0, 2, 3, 1))
    x = g.op("CONV_2D", [x, g.const(conv, "patch_embed/weight"),
                         g.const(w["patch_embed.proj.bias"],
                                 "patch_embed/bias")],
             [1, side, side, dim], "patch_embed", stride=[patch, patch],
             dilation=[1, 1], padding="VALID", activation="NONE")
    shape = [1, side * side, dim]
    x = g.reshape(x, shape, shape, "patch_embed/tokens")
    x = g.layer_norm(x, shape, "patch_embed.norm")
    for i, s in enumerate(st):
        for j in range(s["depth"]):
            x = g.block(x, s, f"layers.{i}.blocks.{j}",
                        s["shift"] if j % 2 else 0)
        if i + 1 < len(st):
            x = g.merge(x, s, f"layers.{i}.downsample")
    last = st[-1]
    tokens, c = last["res"] ** 2, last["dim"]
    x = g.layer_norm(x, [1, tokens, c], "norm")
    x = g.reshape(x, [1, tokens * c], [1, tokens * c], "flatten")
    x = g.linear_bn(x, c, "feature.0.weight", "feature.1", "feature.0")
    emb = w["feature.2.weight"].shape[0]
    x = g.linear_bn(x, emb, "feature.2.weight", "feature.3", "feature.2")
    return g.graph([inputs], [x])


def block_graph(w, stage, block, size, window):
    """(graph JSON dict, constants) of block ``block`` of stage ``stage``
    of ``w`` alone (shifted where it is odd and the stage shifts), on an
    input of [1, tokens, C]."""
    g = _Writer(w)
    s = _stages_of(w, size, window)[stage]
    x = g.tensor([1, s["res"] ** 2, s["dim"]], "input")
    y = g.block(x, s, f"layers.{stage}.blocks.{block}",
                s["shift"] if block % 2 else 0)
    return g.graph([x], [y])


def write(out_dir, seed, input=None, patch=None, dim=None, depths=None,
          heads=None, window=None, mlp_ratio=None, embedding=None,
          files=(GRAPH_FILE, WEIGHTS_FILE)):
    """Write ``files`` of the seeded net (by default both: the program's
    graph and the reference's weights) into ``out_dir``; returns it.
    Unset sizes are the published ones."""
    sizes = _sizes(input=input, patch=patch, dim=dim, depths=depths,
                   heads=heads, window=window, mlp_ratio=mlp_ratio,
                   embedding=embedding)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    w = draw_weights(seed, **sizes)
    if GRAPH_FILE in files:
        graph, consts = graph_from_weights(w, sizes["input"],
                                           sizes["window"])
        save_npz(out / GRAPH_FILE,
                 {"__graph__": np.array(json.dumps(graph)), **consts})
    if WEIGHTS_FILE in files:
        save_npz(out / WEIGHTS_FILE, w)
    return out


def write_config(config, root, files=(GRAPH_FILE, WEIGHTS_FILE)):
    """Write ``files`` of a configuration's net (its ``weights_seed`` and
    published ``widths``) into ``model_dir``; returns the directory."""
    s = config["widths"]
    return write(model_dir(config, root), config["weights_seed"],
                 s["input"][0], s["patch"], s["dim"], s["depths"],
                 s["heads"], s["window"], s["mlp_ratio"], s["embedding"],
                 files)
