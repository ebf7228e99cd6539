"""A dense 3x3 convolution of an f32 net on the card's tensor cores, in
split TF32, at f32 accuracy (``csrc/conv3x3_tc.cu``):

    y[b, co, oy, ox] = sum over (ci, ky, kx) of
        x[b, ci, oy*s + ky - p, ox*s + kx - p] * w[co, ci, ky, kx]

x [B, Cin, H, W] f32 and channels_last, w [Cout, Cin, 3, 3], stride s 1 or
2, symmetric padding p 0 or 1 (taps outside the image read zero), no bias;
y channels_last.  With ``scale`` and ``shift`` (f32 [Cin] each: a
BatchNorm before the conv, which cannot fold into a zero-padded conv's
weights) x is read as ``x * scale + shift`` inside the image, rounded as
the two ops round, the padding still zero.  The kernel reads the weights
split once into TF32 hi and lo parts (``kernel_weights``) and splits x
(after the affine) as it loads it; it sums
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32.  Where the caller allows TF32 in
convolutions (``torch.backends.cudnn.allow_tf32``, the flag cuDNN's f32
convolutions follow) it takes a_hi*b_hi alone, at TF32's accuracy, as
cuDNN would.  That mode is for the benchmark's TF32 control and the
tests alone: every entry point of the package (the pipelines' calls, the
models, the captured programs, ``aot``'s programs) runs its nets under
``exact_f32``, which clears the flag.  A caller of ``conv3x3_tc`` outside
them who leaves cuDNN's default flag set gets TF32.

The registered operator ``torch.ops.tpu_face_torch.conv3x3_tc``
(``conv_op``) launches the kernel on a CUDA tensor, runs
``conv3x3_tc_plain`` (``F.conv2d`` on the f32 operands) on a CPU tensor,
and gives ``torch.export`` the output's shape and channels_last strides
through its fake implementation.  ``conv3x3_tc`` checks the operands and
calls it.  ``LAUNCHES`` counts the kernel's launches; the plain path never
adds to it.  ``routes`` is the shape rule by which
``compiler.lowering.TFLiteNet`` sends a CONV_2D of an f32 net here.
The TF32 split, the tile order of the weights' parts and the plan of a
launch (N tile and grid from the GEMM's shape) are ``wgmma_tf32``'s,
shared with ``fc_tc``.
"""

import torch
import torch.nn.functional as F

from . import _build
from .wgmma_tf32 import BK, plan, sms, tiles

LAUNCHES = 0


def routes(w_shape, c_in, stride, dilation, pads, dtype) -> bool:
    """Whether a CONV_2D of OHWI weights ``w_shape`` on an input of
    ``c_in`` channels, with ``stride``, ``dilation`` and ``pads``
    (((top, bottom), (left, right))), in a net computing in ``dtype``,
    runs on the kernel: f32, a dense 3x3 window (groups 1, dilation 1),
    the same stride 1 or 2 on both axes, the same padding 0 or 1 on all
    four sides, Cin at least 64 and a multiple of 32, Cout a multiple of
    64."""
    co, kh, kw, ci = w_shape
    (pt, pb), (pl, pr) = pads
    return (dtype == torch.float32 and (kh, kw) == (3, 3) and ci == c_in
            and tuple(dilation) == (1, 1) and stride[0] == stride[1]
            and stride[0] in (1, 2) and pt == pb == pl == pr
            and pt in (0, 1) and ci >= 64 and ci % 32 == 0 and co % 64 == 0)


def kernel_weights(w):
    """The hi and lo parts of OIHW weights ``w`` [Cout, Cin, 3, 3] in the
    kernel's tile order, each [9 Cin / 32, Cout, 32]: ``tiles`` of w as
    [Cout, 9 Cin] in (ky, kx, ci) order, so K step k is tap ky*3 + kx and
    channels 32j .. 32j + 31 with k = tap * Cin / 32 + j."""
    co, ci = w.shape[:2]
    return tiles(w.permute(0, 2, 3, 1).reshape(co, 9 * ci))


def out_size(size, stride, pad):
    return (size + 2 * pad - 3) // stride + 1


def conv3x3_tc_plain(x, w, stride: int, pad: int, scale=None, shift=None):
    """``F.conv2d`` on the f32 operands, after ``x * scale + shift`` (two
    ops, per channel) where given, the output channels_last."""
    if scale is not None:
        x = x * scale[:, None, None] + shift[:, None, None]
    return F.conv2d(x, w, None, stride, pad).contiguous(
        memory_format=torch.channels_last)


def _check(x, w, w_hi, w_lo, stride, pad, scale=None, shift=None):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32 [B, C, H, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, ci, h, wd = x.shape
    if (w.dim() != 4 or tuple(w.shape[1:]) != (ci, 3, 3)
            or w.dtype != torch.float32 or w.shape[0] % 64 or ci % BK
            or ci < 64):
        raise ValueError(f"w must be f32 [Cout, {ci}, 3, 3] with Cout a "
                         f"multiple of 64 and Cin a multiple of 32 from 64, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if stride not in (1, 2) or pad not in (0, 1):
        raise ValueError(f"stride must be 1 or 2 and pad 0 or 1, got "
                         f"{stride}, {pad}")
    if min(h, wd) + 2 * pad < 3:
        raise ValueError(f"a {h}x{wd} image padded by {pad} is smaller than "
                         f"the 3x3 window")
    want = (9 * ci // BK, w.shape[0], BK)
    for name, t in (("w_hi", w_hi), ("w_lo", w_lo)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be contiguous f32 {list(want)} on "
                             f"{x.device} (kernel_weights)")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (tuple(t.shape) != (ci,)
                              or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"{name} must be contiguous f32 [{ci}] on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _empty_out(x, w, stride, pad):
    b, _, h, wd = x.shape
    return torch.empty((b, w.shape[0], out_size(h, stride, pad),
                        out_size(wd, stride, pad)), dtype=torch.float32,
                       device=x.device, memory_format=torch.channels_last)


def _conv_cuda(x, w, w_hi, w_lo, stride, pad, scale=None, shift=None):
    """One launch of ``csrc/conv3x3_tc.cu``."""
    global LAUNCHES
    _check(x, w, w_hi, w_lo, stride, pad, scale, shift)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be channels_last, got strides "
                         f"{x.stride()}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x holds {x.numel()} elements; the kernel indexes "
                         f"pixels with 32 bits")
    y = _empty_out(x, w, stride, pad)
    if y.numel() == 0:
        return y
    for t in (x, w_hi, w_lo, y, scale, shift):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernel's operands must be 16-byte aligned")
    b, ci, h, wd = x.shape
    co = w.shape[0]
    dev = x.get_device()
    bn, grid = plan(b * y.shape[2] * y.shape[3], co, sms(dev))
    _build.launch(_build.entry("conv3x3_tc", "conv3x3_tc_f32"), dev,
                  x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                  None if scale is None else scale.data_ptr(),
                  None if shift is None else shift.data_ptr(),
                  y.data_ptr(), b, h, wd, ci, co, stride, pad, bn, grid,
                  int(torch.backends.cudnn.allow_tf32))
    LAUNCHES += 1
    return y


def _conv_cpu(x, w, w_hi, w_lo, stride, pad, scale=None, shift=None):
    return conv3x3_tc_plain(x, w, stride, pad, scale, shift)


def _conv_fake(x, w, w_hi, w_lo, stride, pad, scale=None, shift=None):
    return _empty_out(x, w, stride, pad)


# the convolution of x by w (OIHW, the plain version's operand) and its
# kernel_weights parts w_hi and w_lo (the kernel's), stride, padding, and
# the input affine's scale and shift (or none)
conv_op = _build.register(
    "conv3x3_tc", "(Tensor x, Tensor w, Tensor w_hi, Tensor w_lo, int stride, "
    "int pad, Tensor? scale=None, Tensor? shift=None) -> Tensor", _conv_cpu,
    _conv_cuda, _conv_fake)


def conv3x3_tc(x, w, w_hi, w_lo, stride: int, pad: int, scale=None,
               shift=None):
    """The 3x3 convolution of x by w through ``conv_op``: the CUDA kernel
    (on ``w_hi`` and ``w_lo``, ``kernel_weights(w)``) for a CUDA tensor,
    ``conv3x3_tc_plain`` for a CPU tensor; x read as ``x * scale +
    shift`` per channel where ``scale`` and ``shift`` are given.  The
    kernel takes one TF32 product a step where
    ``torch.backends.cudnn.allow_tf32`` is set at the call (PyTorch's
    default): call it under ``exact_f32`` for f32 accuracy, as the
    package's entry points do; only the benchmark's TF32 control and the
    tests call it with the flag set."""
    if not x.is_cuda:            # the CUDA implementation checks its own
        _check(x, w, w_hi, w_lo, stride, pad, scale, shift)
    return conv_op(x, w, w_hi, w_lo, stride, pad, scale, shift)
