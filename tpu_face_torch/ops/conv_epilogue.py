"""The epilogue of a dense convolution of the lowered nets in one pass:

    out = act(y + bias[c] + skip[c])

over the convolution's f32 output y [B, C, H, W] (NCHW or channels_last,
the skip in either),
``skip`` a residual operand of C_skip <= C channels (zero past them: an
absorbed channel PAD), ``act`` none, RELU, RELU6 or PRELU (``alpha``, one
per channel, as ``max(v, 0) + alpha * min(v, 0)``).  Each step is the
op-by-op path's, in its order and rounded to f32 as it rounds, so on the
card the kernel (``csrc/conv_epilogue.cu``) equals ATen's sequence bit for
bit, cuDNN's convolution being called without a bias (ATen's cuDNN route
adds a bias after the convolution as a separate op anyway).

The registered operator ``torch.ops.tpu_face_torch.conv_epilogue``
(``epilogue_op``) launches the kernel on a CUDA tensor, runs
``conv_epilogue_plain`` (the op-by-op sequence) on a CPU tensor, and gives
``torch.export`` the output's shape and strides through its fake
implementation.  ``conv_epilogue`` checks the operands and calls it.
``LAUNCHES`` counts the kernel's launches; the plain path never adds to
it.  ``compiler.lowering.TFLiteNet`` finds the chains that end in one
(``_epilogue_chains``).
"""

import torch

from . import _build

LAUNCHES = 0

# activation -> the kernel's code
ACTS = {"NONE": 0, "RELU": 1, "RELU6": 2, "PRELU": 3}


def conv_epilogue_plain(y, bias, skip, alpha, act: int,
                        skip_first: bool = False):
    """The op-by-op sequence: the bias add, the residual ADD (the skip
    zero-padded to y's channels, as the channel PAD makes it; the skip
    the ADD's first operand where ``skip_first``), then the activation as
    ``TFLiteNet`` computes it."""
    if bias is not None:
        y = y + bias[:, None, None]
    if skip is not None:
        if skip.shape[1] < y.shape[1]:
            skip = torch.nn.functional.pad(
                skip, (0, 0, 0, 0, 0, y.shape[1] - skip.shape[1]))
        y = skip + y if skip_first else y + skip
    if act == ACTS["RELU"]:
        return torch.relu(y)
    if act == ACTS["RELU6"]:
        return torch.clamp(y, 0.0, 6.0)
    if act == ACTS["PRELU"]:
        return (torch.clamp(y, min=0)
                + alpha.reshape(1, -1, 1, 1) * torch.clamp(y, max=0))
    return y


def channels_last(t) -> bool:
    """Whether the kernel reads or writes [B, C, H, W] ``t`` as
    channels_last pixels (True) or NCHW planes (False): the layout it is
    dense in, NCHW where it is dense in both (one channel or one pixel:
    the two index alike).  Raises ``ValueError`` where it is dense in
    neither."""
    if t.is_contiguous():
        return False
    if t.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(f"a tensor of strides {t.stride()} is neither "
                     f"NCHW-contiguous nor channels_last")


def _empty_out(y, skip, skip_first):
    """The output, in the layout the op-by-op sequence gives it: that of
    the ADD's first operand where it is dense in one layout only (the
    skip where ``skip_first``), else y's strides."""
    if skip is not None and skip_first:
        nchw = skip.is_contiguous()
        if nchw != skip.is_contiguous(memory_format=torch.channels_last):
            return torch.empty_like(
                y, memory_format=(torch.contiguous_format if nchw
                                  else torch.channels_last))
    return torch.empty_like(y)


def _check(y, bias, skip, alpha, act):
    if y.dim() != 4 or y.dtype != torch.float32:
        raise ValueError(f"y must be f32 [B, C, H, W], got {y.dtype} "
                         f"{tuple(y.shape)}")
    b, c, h, w = y.shape
    if c * h * w >= 2 ** 31:
        raise ValueError(f"an image of y holds {c * h * w} elements; the "
                         f"kernel indexes fewer than 2^31")
    if act not in ACTS.values():
        raise ValueError(f"act must be one of {ACTS}, got {act}")
    if (alpha is None) == (act == ACTS["PRELU"]):
        raise ValueError("alpha is given for PRELU and only for it")
    for name, t in (("bias", bias), ("alpha", alpha)):
        if t is not None and (t.numel() != c or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != y.device):
            raise ValueError(f"{name} must be {c} contiguous f32 values on "
                             f"{y.device}")
    if skip is not None and (
            skip.dim() != 4 or skip.dtype != torch.float32
            or skip.device != y.device or skip.shape[0] != b
            or not 1 <= skip.shape[1] <= c
            or tuple(skip.shape[2:]) != (h, w)):
        raise ValueError(f"skip must be f32 [{b}, <= {c}, {h}, {w}] on "
                         f"{y.device}, got {skip.dtype} "
                         f"{tuple(skip.shape)}")
    for t in (y, skip):
        if t is not None:
            channels_last(t)


def _epilogue_cuda(y, bias, skip, alpha, act, skip_first=False):
    """One launch of ``csrc/conv_epilogue.cu``."""
    global LAUNCHES
    _check(y, bias, skip, alpha, act)
    b, c, h, w = y.shape
    out = _empty_out(y, skip, skip_first)
    layouts = (channels_last(out) | channels_last(y) << 1
               | (0 if skip is None else channels_last(skip) << 2))
    _build.launch(
        _build.entry("conv_epilogue", "conv_epilogue_f32"), y.get_device(),
        y.data_ptr(), None if bias is None else bias.data_ptr(),
        None if skip is None else skip.data_ptr(),
        None if alpha is None else alpha.data_ptr(), out.data_ptr(), b, c,
        c if skip is None else skip.shape[1], h * w, layouts, act)
    LAUNCHES += 1
    return out


def _epilogue_fake(y, bias, skip, alpha, act, skip_first=False):
    return _empty_out(y, skip, skip_first)


# the epilogue of y with its bias, skip, alpha (each optional), activation
# code (``ACTS``) and operand order
epilogue_op = _build.register(
    "conv_epilogue", "(Tensor y, Tensor? bias, Tensor? skip, Tensor? alpha, "
    "int act, bool skip_first=False) -> Tensor", conv_epilogue_plain,
    _epilogue_cuda, _epilogue_fake)


def conv_epilogue(y, bias=None, skip=None, alpha=None, act: str = "NONE",
                  skip_first: bool = False):
    """``act(y + bias + skip)`` through ``epilogue_op``: the CUDA kernel for
    a CUDA tensor, ``conv_epilogue_plain`` for a CPU tensor.  ``act`` is a
    key of ``ACTS``; ``skip_first``: the skip is the ADD's first operand
    (the output takes its layout, as the op-by-op ADD's does)."""
    code = ACTS[act]
    if not y.is_cuda:            # the CUDA implementation checks its own
        _check(y, bias, skip, alpha, code)
    return epilogue_op(y, bias, skip, alpha, code, skip_first)
