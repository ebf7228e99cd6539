"""insightface's face-recognition Vision Transformer (``recognition/
arcface_torch/backbones/vit.py``, ``VisionTransformer``, ``Block``,
``Attention`` and ``Mlp``; arXiv:2010.11929) with seeded weights, written
as two files into a directory:

* ``face_embeddings.npz``: the net as a converted TFLite graph, in the
  schema of ``tools/convert_tflite.py``, as the TFLite converter emits a
  torch ViT: the input map (0, 1) -> (-1, 1) as a MUL and an ADD; the
  patch embedding a VALID CONV_2D of stride and window ``patch``; a
  RESHAPE to [1, tokens, dim] in torch's ``flatten(2).transpose(1, 2)``
  order (row-major over the patch grid); the ``pos_embed`` ADD; each
  LayerNorm decomposed (MEAN, SUB, MUL, MEAN, ADD eps, RSQRT, MUL, MUL
  gamma, ADD beta over the last axis); each Linear a FULLY_CONNECTED over
  the tokens (``keep_num_dims``), ReLU6 fused into ``fc1``; the attention
  core RESHAPE and TRANSPOSE into heads, BATCH_MATMUL (``adj_y``), the
  scale as a MUL, SOFTMAX, BATCH_MATMUL, TRANSPOSE and RESHAPE back; the
  flatten a RESHAPE to [1, tokens * dim]; the two ``feature`` Linears with
  their BatchNorm1d folded into weights and a bias.  Output: the raw
  512-d embedding.
* ``vit_weights.npz``: the same weights unfolded, under insightface's
  state-dict names, for a plain reference of the published equations.

One departure from the converter: ``qkv`` (no bias) is three
FULLY_CONNECTED over its row blocks q, k and v, each read by its own head
split.  The lowered op set (the JAX package's and the port's) has no SPLIT
or STRIDED_SLICE to cut one product's output in three; the products are
the same.

Plain numpy: no TensorFlow, no torch.  The same seed and sizes give the
same bytes: ``write(out_dir, seed)``.

Weights (no trained ViT is in the repository): each width drawn so the
mechanism does real work at every depth.  The patch embedding and the
value and MLP products keep unit variance; q and k are drawn so that a
head's logits ``q.k / sqrt(head_dim)`` have a standard deviation near 2,
so each softmax over the tokens is peaked, not near-uniform; ``proj`` and
``fc2`` are scaled so each residual branch adds a variance near 0.04 and
the stream stays O(1) through all blocks; ``fc1``'s pre-activations have a
standard deviation near 2, so ReLU6 clips some; each BatchNorm1d's running
statistics are drawn around the unit variance its input has.
"""

import json
from pathlib import Path

import numpy as np

from .iresnet import _Writer as _GraphWriter
# a configuration's files go where R100's do: ``model_dir``
from .iresnet import model_dir, save_npz

# vit_l_dp005_mask_005 (backbones/__init__.py): input side, patch, width,
# blocks, heads, MLP hidden width, embedding width
PUBLISHED = {"input": 112, "patch": 9, "dim": 768, "depth": 24, "heads": 8,
             "mlp": 3072, "embedding": 512}
LN_EPS = 1e-5                     # nn.LayerNorm's default
BN_EPS = 2e-5                     # feature's BatchNorm1d
GRAPH_FILE = "face_embeddings.npz"
WEIGHTS_FILE = "vit_weights.npz"
# a head's logits' standard deviation, the residual branches' variance
LOGIT_STD = 2.0
BRANCH_VAR = 0.04
FC1_STD = 2.0


def _sizes(**given):
    """The published sizes, updated by the ``given`` ones that are set."""
    return dict(PUBLISHED, **{k: v for k, v in given.items()
                              if v is not None})


def param_shapes(input, patch, dim, depth, heads, mlp, embedding):
    """{insightface name: shape} of every tensor of the state dict."""
    tokens = (input // patch) ** 2
    shapes = {"patch_embed.proj.weight": (dim, 3, patch, patch),
              "patch_embed.proj.bias": (dim,),
              "pos_embed": (1, tokens, dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            shapes[f"{p}.{norm}.weight"] = shapes[f"{p}.{norm}.bias"] = (dim,)
        shapes[f"{p}.attn.qkv.weight"] = (3 * dim, dim)
        shapes[f"{p}.attn.proj.weight"] = (dim, dim)
        shapes[f"{p}.attn.proj.bias"] = (dim,)
        shapes[f"{p}.mlp.fc1.weight"] = (mlp, dim)
        shapes[f"{p}.mlp.fc1.bias"] = (mlp,)
        shapes[f"{p}.mlp.fc2.weight"] = (dim, mlp)
        shapes[f"{p}.mlp.fc2.bias"] = (dim,)
    shapes["norm.weight"] = shapes["norm.bias"] = (dim,)
    shapes["feature.0.weight"] = (dim, tokens * dim)
    shapes["feature.2.weight"] = (embedding, dim)
    for bn, c in (("feature.1", dim), ("feature.3", embedding)):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{k}"] = (c,)
    return shapes


def parameters(shapes):
    """Trainable parameters among ``shapes`` (BN running statistics are
    buffers)."""
    return sum(int(np.prod(s)) for k, s in shapes.items()
               if "running" not in k)


def draw_weights(seed, input, patch, dim, depth, heads, mlp, embedding):
    """{insightface name: float32 array} of a ViT of these sizes, from
    ``seed`` (drawn in float32: the published net is 1.02 GB)."""
    rng = np.random.default_rng(seed)
    if dim % heads:
        raise ValueError(f"width {dim} is no multiple of {heads} heads")
    shapes = param_shapes(input, patch, dim, depth, heads, mlp, embedding)

    def normal(name, std):
        x = rng.standard_normal(shapes[name], dtype=np.float32)
        x *= np.float32(std)
        return x

    def uniform(name, lo, hi):
        return rng.uniform(lo, hi, shapes[name]).astype(np.float32)

    w = {}
    # inputs in (-1, 1), about a third of unit variance a pixel: the
    # tokens near unit variance
    w["patch_embed.proj.weight"] = normal("patch_embed.proj.weight",
                                          np.sqrt(3.0 / (3 * patch * patch)))
    w["patch_embed.proj.bias"] = normal("patch_embed.proj.bias", 0.02)
    w["pos_embed"] = normal("pos_embed", 0.1)
    # q.k / sqrt(head_dim) over head_dim products of unit-variance LN
    # outputs has variance (dim * var_qk)^2: LOGIT_STD from var_qk
    qk_std = np.sqrt(LOGIT_STD / dim)
    for i in range(depth):
        p = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            w[f"{p}.{norm}.weight"] = uniform(f"{p}.{norm}.weight", 0.8, 1.2)
            w[f"{p}.{norm}.bias"] = normal(f"{p}.{norm}.bias", 0.05)
        qkv = rng.standard_normal(shapes[f"{p}.attn.qkv.weight"],
                                  dtype=np.float32)
        qkv[:2 * dim] *= np.float32(qk_std)
        qkv[2 * dim:] *= np.float32(np.sqrt(1.0 / dim))
        w[f"{p}.attn.qkv.weight"] = qkv
        # values of unit variance: proj's output has BRANCH_VAR
        w[f"{p}.attn.proj.weight"] = normal(f"{p}.attn.proj.weight",
                                            np.sqrt(BRANCH_VAR / dim))
        w[f"{p}.attn.proj.bias"] = normal(f"{p}.attn.proj.bias", 0.02)
        w[f"{p}.mlp.fc1.weight"] = normal(f"{p}.mlp.fc1.weight",
                                          FC1_STD / np.sqrt(dim))
        w[f"{p}.mlp.fc1.bias"] = normal(f"{p}.mlp.fc1.bias", 0.05)
        # ReLU6 of N(0, FC1_STD^2) has a second moment near FC1_STD^2 / 2
        w[f"{p}.mlp.fc2.weight"] = normal(
            f"{p}.mlp.fc2.weight",
            np.sqrt(BRANCH_VAR / (mlp * FC1_STD ** 2 / 2)))
        w[f"{p}.mlp.fc2.bias"] = normal(f"{p}.mlp.fc2.bias", 0.02)
    w["norm.weight"] = uniform("norm.weight", 0.8, 1.2)
    w["norm.bias"] = normal("norm.bias", 0.05)
    flat = shapes["feature.0.weight"][1]
    w["feature.0.weight"] = normal("feature.0.weight", np.sqrt(1.0 / flat))
    w["feature.2.weight"] = normal("feature.2.weight", np.sqrt(1.0 / dim))
    # each BatchNorm1d sees about unit variance (its Linear keeps it)
    for bn in ("feature.1", "feature.3"):
        w[f"{bn}.weight"] = uniform(f"{bn}.weight", 0.8, 1.2)
        w[f"{bn}.bias"] = normal(f"{bn}.bias", 0.05)
        w[f"{bn}.running_mean"] = normal(f"{bn}.running_mean", 0.05)
        w[f"{bn}.running_var"] = uniform(f"{bn}.running_var", 0.8, 1.25)
    return w


class _Writer(_GraphWriter):
    """The ViT's ops in the converter's schema, from weights ``w`` under
    insightface's names."""

    def __init__(self, w, heads):
        super().__init__(w)
        self.heads = heads

    def fc(self, x, shape, weight, bias=None, name="", activation="NONE",
           keep_num_dims=True):
        """FULLY_CONNECTED of ``x`` by ``weight`` [out, in] (an array)."""
        ins = [x, self.const(weight, f"{name}/weight")]
        if bias is not None:
            ins.append(self.const(bias, f"{name}/bias"))
        return self.op("FULLY_CONNECTED", ins, shape, name,
                       activation=activation, keep_num_dims=keep_num_dims)

    def layer_norm(self, x, shape, name):
        """``nn.LayerNorm`` over the last axis, as the converter
        decomposes it."""
        axis = self.const(np.array([-1], np.int32), f"{name}/axis")
        stat = shape[:-1] + [1]
        mean = self.op("MEAN", [x, axis], stat, f"{name}/mean",
                       keep_dims=True)
        d = self.op("SUB", [x, mean], shape, f"{name}/sub",
                    activation="NONE")
        sq = self.op("MUL", [d, d], shape, f"{name}/square",
                     activation="NONE")
        var = self.op("MEAN", [sq, axis], stat, f"{name}/var",
                      keep_dims=True)
        var = self.op("ADD", [var, self.const(np.array(LN_EPS, np.float32),
                                              f"{name}/eps")],
                      stat, f"{name}/add_eps", activation="NONE")
        r = self.op("RSQRT", [var], stat, f"{name}/rsqrt")
        y = self.op("MUL", [d, r], shape, f"{name}/normalize",
                    activation="NONE")
        y = self.op("MUL", [y, self.const(self.w[f"{name}.weight"],
                                          f"{name}/gamma")],
                    shape, f"{name}/scale", activation="NONE")
        return self.op("ADD", [y, self.const(self.w[f"{name}.bias"],
                                             f"{name}/beta")],
                       shape, f"{name}/shift", activation="NONE")

    def attention(self, x, tokens, dim, p):
        """``Attention``: q, k and v, the attention core, ``proj``."""
        heads, hd = self.heads, dim // self.heads
        qkv = self.w[f"{p}.attn.qkv.weight"]
        parts = [self.fc(x, [1, tokens, dim], qkv[j * dim:(j + 1) * dim],
                         name=f"{p}.attn.{n}")
                 for j, n in enumerate("qkv")]
        split = self.const(np.array([1, tokens, heads, hd], np.int32),
                           f"{p}.attn/split")
        perm = self.const(np.array([0, 2, 1, 3], np.int32), f"{p}.attn/perm")
        q, k, v = (self.op("TRANSPOSE", [self.op(
            "RESHAPE", [t, split], [1, tokens, heads, hd],
            f"{p}.attn.{n}/heads"), perm], [1, heads, tokens, hd],
            f"{p}.attn.{n}/transpose") for t, n in zip(parts, "qkv"))
        s = self.op("BATCH_MATMUL", [q, k], [1, heads, tokens, tokens],
                    f"{p}.attn/scores", adj_x=False, adj_y=True)
        s = self.op("MUL", [s, self.const(np.array(hd ** -0.5, np.float32),
                                          f"{p}.attn/scale")],
                    [1, heads, tokens, tokens], f"{p}.attn/scaled",
                    activation="NONE")
        a = self.op("SOFTMAX", [s], [1, heads, tokens, tokens],
                    f"{p}.attn/softmax", beta=1.0)
        y = self.op("BATCH_MATMUL", [a, v], [1, heads, tokens, hd],
                    f"{p}.attn/context", adj_x=False, adj_y=False)
        y = self.op("TRANSPOSE", [y, perm], [1, tokens, heads, hd],
                    f"{p}.attn/merge")
        y = self.op("RESHAPE", [y, self.const(
            np.array([1, tokens, dim], np.int32), f"{p}.attn/merged")],
            [1, tokens, dim], f"{p}.attn/merged")
        return self.fc(y, [1, tokens, dim], self.w[f"{p}.attn.proj.weight"],
                       self.w[f"{p}.attn.proj.bias"], f"{p}.attn.proj")

    def block(self, x, tokens, dim, p):
        """``Block``: x + attn(LN1(x)), then x + fc2(ReLU6(fc1(LN2(x))))."""
        shape = [1, tokens, dim]
        y = self.attention(self.layer_norm(x, shape, f"{p}.norm1"), tokens,
                           dim, p)
        x = self.op("ADD", [x, y], shape, f"{p}.attn/residual",
                    activation="NONE")
        y = self.layer_norm(x, shape, f"{p}.norm2")
        mlp = self.w[f"{p}.mlp.fc1.weight"].shape[0]
        y = self.fc(y, [1, tokens, mlp], self.w[f"{p}.mlp.fc1.weight"],
                    self.w[f"{p}.mlp.fc1.bias"], f"{p}.mlp.fc1",
                    activation="RELU6")
        y = self.fc(y, shape, self.w[f"{p}.mlp.fc2.weight"],
                    self.w[f"{p}.mlp.fc2.bias"], f"{p}.mlp.fc2")
        return self.op("ADD", [x, y], shape, f"{p}.mlp/residual",
                       activation="NONE")

    def linear_bn(self, x, out, linear, bn, name):
        """A bias-free Linear with the BatchNorm1d after it folded in
        (float64, stored float32)."""
        g, b, m, v = (self.w[f"{bn}.{k}"].astype(np.float64) for k in
                      ("weight", "bias", "running_mean", "running_var"))
        scale = g / np.sqrt(v + BN_EPS)
        weight = (self.w[linear].astype(np.float64) * scale[:, None])
        return self.fc(x, [1, out], weight.astype(np.float32),
                       (b - m * scale).astype(np.float32), name,
                       keep_num_dims=False)


def graph_from_weights(w, heads, size):
    """(graph JSON dict, {"t<id>": constant}) of the converted net on
    inputs of ``size``² (the patch grid drops what is left past its last
    whole patch, as the VALID convolution does)."""
    g = _Writer(w, heads)
    dim, _, patch, _ = w["patch_embed.proj.weight"].shape
    _, tokens, _ = w["pos_embed"].shape
    side = size // patch
    depth = len({k.split(".")[1] for k in w if k.startswith("blocks.")})
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
    shape = [1, tokens, dim]
    x = g.op("RESHAPE", [x, g.const(np.array(shape, np.int32),
                                    "patch_embed/tokens")], shape,
             "patch_embed/tokens")
    x = g.op("ADD", [x, g.const(w["pos_embed"], "pos_embed")], shape,
             "pos_embed", activation="NONE")
    for i in range(depth):
        x = g.block(x, tokens, dim, f"blocks.{i}")
    x = g.layer_norm(x, shape, "norm")
    x = g.op("RESHAPE", [x, g.const(np.array([1, tokens * dim], np.int32),
                                    "flatten/shape")],
             [1, tokens * dim], "flatten")
    x = g.linear_bn(x, dim, "feature.0.weight", "feature.1", "feature.0")
    emb = w["feature.2.weight"].shape[0]
    x = g.linear_bn(x, emb, "feature.2.weight", "feature.3", "feature.2")
    return g.graph([inputs], [x])


def block_graph(w, heads):
    """(graph JSON dict, constants) of the first block of ``w`` alone, on
    an input of [1, tokens, dim]."""
    g = _Writer(w, heads)
    _, tokens, dim = w["pos_embed"].shape
    x = g.tensor([1, tokens, dim], "input")
    y = g.block(x, tokens, dim, "blocks.0")
    return g.graph([x], [y])


def write(out_dir, seed, input=None, patch=None, dim=None, depth=None,
          heads=None, mlp=None, embedding=None,
          files=(GRAPH_FILE, WEIGHTS_FILE)):
    """Write ``files`` of the seeded net (by default both: the program's
    graph and the reference's weights) into ``out_dir``; returns it.
    Unset sizes are the published ones."""
    sizes = _sizes(input=input, patch=patch, dim=dim, depth=depth,
                   heads=heads, mlp=mlp, embedding=embedding)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    w = draw_weights(seed, **sizes)
    if GRAPH_FILE in files:
        graph, consts = graph_from_weights(w, sizes["heads"],
                                           sizes["input"])
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
                 s["input"][0], s["patch"], s["dim"], s["depth"], s["heads"],
                 s["mlp"], s["embedding"], files)
