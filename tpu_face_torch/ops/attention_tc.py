"""A transformer's attention core of an f32 net, from the head split to the
head merge, as one launch of a hand-written kernel (``csrc/attention_tc.cu``):
for each sequence s and head h, in the lowered graph's order,

    x = (q_h . k_h^T) * scale  [+ bias[h]]  [+ mask[s mod nW]]
    o_h = softmax(x) . v_h

q, k and v [S, N, heads * d] f32 (the q, k and v FCs' outputs, head h at
columns h*d .. h*d + d - 1), o the same (the head merge's layout, which the
output projection reads); ``scale`` a one-element tensor or none, ``bias``
[heads, N, N] or none, ``mask`` [nW, N, N] or none (the shifted windows'
mask, sequence s being window s mod nW of its image).  The kernel keeps the
scores in registers, its two products on the tensor cores in split TF32
(three TF32 products summed in f32), at f32 accuracy.  Where the caller
allows TF32 in matmuls (``torch.backends.cuda.matmul.allow_tf32``, the flag
cuBLAS's f32 products follow) each product is one TF32 product, at TF32's
accuracy: for the benchmark's TF32 control and the tests alone, since every
entry point of the package runs its nets under ``exact_f32``.

The registered operator ``torch.ops.tpu_face_torch.attention_tc``
(``attention_op``) launches the kernel on a CUDA tensor, runs
``attention_tc_plain`` (the graph's ATen ops) on a CPU tensor, and gives
``torch.export`` the output's shape through its fake implementation.
``attention_tc`` checks the operands and calls it.  ``LAUNCHES`` counts the
kernel's launches; the plain path never adds to it.  ``routes`` is the
shape rule by which ``compiler.lowering.TFLiteNet`` sends an attention core
of an f32 net here.
"""

import torch

from . import _build

LAUNCHES = 0

# the longest sequence: a warp holds its 16 rows' scores over every key in
# registers (18 tiles of 8 keys)
N_MAX = 144
# the widest head: a warp's 16 output rows in registers (12 tiles of 8)
D_MAX = 96
# the shared memory a CTA may take (an H100's 227 KB)
SMEM_MAX = 232448


def smem_bytes(n, d, tables) -> int:
    """The shared memory of the kernel's CTA (``smem_floats`` in
    ``csrc/attention_tc.cu``) for sequences of ``n`` tokens, heads of
    ``d`` and ``tables`` of a bias and a mask (0 to 2): q and k, 16 and 8
    rows a tile, of d + 4 floats (p over them once they are read, its rows
    padded to 8 mod 16 floats), v, then each table's n * n floats."""
    qrows, keys = 16 * -(-n // 16), 8 * -(-n // 8)
    p_stride = keys if keys % 16 == 8 else keys + 8
    return 4 * (max((qrows + keys) * (d + 4), qrows * p_stride)
                + keys * (d + 4) + tables * n * n)


def routes(n, heads, d, dtype, tables=0) -> bool:
    """Whether an attention core over sequences of ``n`` tokens, ``heads``
    heads of ``d``, with ``tables`` of a bias and a mask, in a net
    computing in ``dtype``, runs on the kernel: f32, n at most ``N_MAX``,
    d a multiple of 8 at most ``D_MAX``, its shared memory at most
    ``SMEM_MAX`` (ViT-L's 144 tokens of 96 with no table: 173 KB;
    Swin-S's 49 of 32 with both: 44 KB)."""
    return (dtype == torch.float32 and 1 <= n <= N_MAX and heads >= 1
            and 8 <= d <= D_MAX and d % 8 == 0
            and smem_bytes(n, d, tables) <= SMEM_MAX)


def attention_tc_plain(q, k, v, scale, bias, mask, heads: int):
    """The core as the lowered graph's ATen ops compute it: the head split
    of q, k and v (RESHAPE, TRANSPOSE), q . k^T, ``* scale``, ``+ bias``,
    the mask's ADD over each image's windows (RESHAPE, ADD, RESHAPE),
    TFLite's SOFTMAX (exp of the difference from the row's max over the
    row's sum), p . v and the head merge, in that order, each an op of its
    own."""
    s, n, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(s, n, heads, d).permute(0, 2, 1, 3)

    x = torch.matmul(split(q), split(k).transpose(-1, -2))
    if scale is not None:
        x = x * scale
    if bias is not None:
        x = x + bias
    if mask is not None:
        nw = mask.shape[0]
        x = (x.reshape(-1, nw, heads, n, n) + mask[:, None]).reshape(
            -1, heads, n, n)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    y = torch.matmul(e / e.sum(-1, keepdim=True), split(v))
    return y.permute(0, 2, 1, 3).reshape(s, n, c)


def _check(q, k, v, scale, bias, mask, heads):
    if q.dim() != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be f32 [S, N, heads * d], got {q.dtype} "
                         f"{tuple(q.shape)}")
    s, n, c = q.shape
    for name, t in (("k", k), ("v", v)):
        if (tuple(t.shape) != (s, n, c) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be f32 {[s, n, c]} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if heads < 1 or c % heads:
        raise ValueError(f"{c} columns do not split into {heads} heads")
    # (name, tensor, its form, whether it has it)
    for name, t, form, ok in (
            ("scale", scale, "one element", lambda t: t.numel() == 1),
            ("bias", bias, f"[{heads}, {n}, {n}]",
             lambda t: tuple(t.shape) == (heads, n, n)),
            ("mask", mask, f"[nW, {n}, {n}] with nW dividing {s}",
             lambda t: t.dim() == 3 and tuple(t.shape[1:]) == (n, n)
             and t.shape[0] >= 1 and s % t.shape[0] == 0)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != q.device or not ok(t)):
            raise ValueError(f"{name} must be f32 {form} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _attention_cuda(q, k, v, scale, bias, mask, heads):
    """One launch of ``csrc/attention_tc.cu``."""
    global LAUNCHES
    _check(q, k, v, scale, bias, mask, heads)
    s, n, c = q.shape
    d = c // heads
    tables = (bias is not None) + (mask is not None)
    if not routes(n, heads, d, q.dtype, tables):
        raise ValueError(f"the kernel takes N <= {N_MAX}, d a multiple of 8 "
                         f"up to {D_MAX} and {SMEM_MAX} bytes of shared "
                         f"memory, got N {n}, d {d}, {tables} tables")
    if s * heads > 2 ** 31 - 1:
        raise ValueError(f"{s} sequences of {heads} heads: the kernel "
                         f"indexes its CTAs with 32 bits")
    operands = [t.contiguous() for t in (q, k, v)]
    consts = [None if t is None else t.contiguous()
              for t in (scale, bias, mask)]
    o = torch.empty_like(operands[0])
    if o.numel() == 0:
        return o
    for t in (*operands, o):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and o must be 16-byte aligned")
    _build.launch(
        _build.entry("attention_tc", "attention_tc_f32"), q.get_device(),
        *(t.data_ptr() for t in operands),
        *(None if t is None else t.data_ptr() for t in consts),
        o.data_ptr(), s, n, heads, d, 0 if mask is None else mask.shape[0],
        int(torch.backends.cuda.matmul.allow_tf32))
    LAUNCHES += 1
    return o


def _attention_fake(q, k, v, scale, bias, mask, heads):
    return torch.empty_like(q)


# the core of q, k and v [S, N, heads * d] with its scale (a one-element
# tensor), bias [heads, N, N] and mask [nW, N, N], each or none
attention_op = _build.register(
    "attention_tc", "(Tensor q, Tensor k, Tensor v, Tensor? scale, "
    "Tensor? bias, Tensor? mask, int heads) -> Tensor", attention_tc_plain,
    _attention_cuda, _attention_fake)


def attention_tc(q, k, v, scale=None, bias=None, mask=None, heads=1):
    """The attention core of q, k and v [S, N, heads * d], [S, N, heads *
    d], through ``attention_op``: the CUDA kernel for a CUDA tensor,
    ``attention_tc_plain`` for a CPU tensor.  The kernel takes one TF32
    product for each of its split's three where
    ``torch.backends.cuda.matmul.allow_tf32`` is set at the call: call it
    under ``exact_f32`` for f32 accuracy, as the package's entry points
    do."""
    if not q.is_cuda:            # the CUDA implementation checks its own
        _check(q, k, v, scale, bias, mask, heads)
    return attention_op(q, k, v, scale, bias, mask, heads)
