"""TFLite's FULLY_CONNECTED over token rows of an f32 net on the card's
tensor cores, in split TF32, at f32 accuracy, its bias and fused
activation in the kernel's epilogue (``csrc/fc_tc.cu``):

    y[m, n] = act(sum over k of x[m, k] * w[n, k] + b[n])

x [M, K] f32 row-major, w [N, K] (TFLite's [out, in]), b [N] or none, act
NONE, RELU or RELU6 (``ACTS``), y [M, N]; K a multiple of 32, N of 64.
The kernel reads the weights split once into TF32 hi and lo parts
(``kernel_weights``, in the convolution kernel's tile order) and splits x
as it loads it; it sums a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32, then adds
the bias and applies the activation as ATen's ``add`` and ``clamp`` round
them.  Where the caller allows TF32 in matmuls
(``torch.backends.cuda.matmul.allow_tf32``, the flag cuBLAS's f32
products follow) it takes a_hi*b_hi alone, at TF32's accuracy, as cuBLAS
would.  That mode is for the benchmark's TF32 control and the tests
alone: every entry point of the package runs its nets under
``exact_f32``, which clears the flag.

The registered operator ``torch.ops.tpu_face_torch.fc_tc`` (``fc_op``)
launches the kernel on a CUDA tensor, runs ``fc_tc_plain`` (``F.linear``
on the f32 operands, then the bias and the activation) on a CPU tensor,
and gives ``torch.export`` the output's shape through its fake
implementation.  ``fc_tc`` checks the operands and calls it.  ``LAUNCHES``
counts the kernel's launches; the plain path never adds to it.
``routes`` is the shape rule by which ``compiler.lowering.TFLiteNet``
sends a FULLY_CONNECTED of an f32 net here; the kernel's tiles, N tile
and grid are ``wgmma_tf32``'s, shared with the convolution kernel.
"""

import math

import torch
import torch.nn.functional as F

from . import _build, wgmma_tf32
from .wgmma_tf32 import BK

LAUNCHES = 0

# the fused activations the kernel applies: {TFLite name: its code}
ACTS = {"NONE": 0, "RELU": 1, "RELU6": 2}


def routes(w_shape, x_shape, keep_num_dims, activation, dtype) -> bool:
    """Whether a FULLY_CONNECTED of weights ``w_shape`` ([out, in]) on an
    input of the graph's shape ``x_shape`` (batch first), with
    ``keep_num_dims`` and the fused ``activation``, in a net computing in
    ``dtype``, runs on the kernel: f32, ``keep_num_dims``, more than one
    row a sample (a token sequence such as [1, 144, 768]), an activation
    of ``ACTS``, K a multiple of 32 and N of 64."""
    if len(w_shape) != 2 or len(x_shape) < 3:
        return False
    n, k = w_shape
    return (dtype == torch.float32 and bool(keep_num_dims)
            and math.prod(x_shape[1:-1]) > 1 and x_shape[-1] == k
            and activation in ACTS and k >= BK and k % BK == 0
            and n >= 64 and n % 64 == 0)


# the hi and lo parts of FC weights [N, K] in the kernel's tile order,
# each [K / 32, N, 32]: the convolution kernel's B tiles
kernel_weights = wgmma_tf32.tiles


def fc_tc_plain(x, w, bias, act: int):
    """``F.linear`` of x [M, K] by w [N, K] on the f32 operands, then
    ``+ bias`` where given, then the activation of code ``act``, each an
    op of its own, as the lowered net ran them before the kernel."""
    y = F.linear(x, w)
    if bias is not None:
        y = y + bias
    if act == ACTS["RELU"]:
        return torch.relu(y)
    if act == ACTS["RELU6"]:
        return torch.clamp(y, 0.0, 6.0)
    return y


def _check(x, w, w_hi, w_lo, bias, act):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    k = x.shape[1]
    if (w.dim() != 2 or w.shape[1] != k or w.dtype != torch.float32
            or w.shape[0] % 64 or w.shape[0] < 64 or k % BK or k < BK):
        raise ValueError(f"w must be f32 [N, {k}] with N a multiple of 64 "
                         f"and K a multiple of 32, got {w.dtype} "
                         f"{tuple(w.shape)}")
    want = (k // BK, w.shape[0], BK)
    for name, t in (("w_hi", w_hi), ("w_lo", w_lo)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be contiguous f32 {list(want)} on "
                             f"{x.device} (kernel_weights)")
    if bias is not None and (tuple(bias.shape) != (w.shape[0],)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()
                             or bias.device != x.device):
        raise ValueError(f"bias must be contiguous f32 [{w.shape[0]}] on "
                         f"{x.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if act not in ACTS.values():
        raise ValueError(f"act must be one of {ACTS}, got {act}")


def _empty_out(x, w):
    return torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                       device=x.device)


def _fc_cuda(x, w, w_hi, w_lo, bias, act):
    """One launch of ``csrc/fc_tc.cu``."""
    global LAUNCHES
    _check(x, w, w_hi, w_lo, bias, act)
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    if x.shape[0] > 2 ** 31 - 257:
        raise ValueError(f"x holds {x.shape[0]} rows; the kernel indexes "
                         f"rows with 32 bits")
    y = _empty_out(x, w)
    if y.numel() == 0:
        return y
    for t in (x, w_hi, w_lo, y, bias):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernel's operands must be 16-byte aligned")
    m, k = x.shape
    n = w.shape[0]
    dev = x.get_device()
    bn, grid = wgmma_tf32.plan(m, n, wgmma_tf32.sms(dev))
    _build.launch(_build.entry("fc_tc", "fc_tc_f32"), dev, x.data_ptr(),
                  w_hi.data_ptr(), w_lo.data_ptr(),
                  None if bias is None else bias.data_ptr(), y.data_ptr(),
                  m, k, n, act, bn, grid,
                  int(torch.backends.cuda.matmul.allow_tf32))
    LAUNCHES += 1
    return y


def _fc_cpu(x, w, w_hi, w_lo, bias, act):
    return fc_tc_plain(x, w, bias, act)


def _fc_fake(x, w, w_hi, w_lo, bias, act):
    return _empty_out(x, w)


# the FC of x [M, K] by w ([N, K], the plain version's operand) and its
# kernel_weights parts w_hi and w_lo (the kernel's), the bias (or none)
# and the activation's code
fc_op = _build.register(
    "fc_tc", "(Tensor x, Tensor w, Tensor w_hi, Tensor w_lo, Tensor? bias, "
    "int act) -> Tensor", _fc_cpu, _fc_cuda, _fc_fake)


def fc_tc(x, w, w_hi, w_lo, bias=None, activation="NONE"):
    """The FC of x [..., K] by w [N, K] with ``bias`` and the fused
    ``activation`` (a name of ``ACTS``), [..., N], through ``fc_op``: the
    CUDA kernel (on ``w_hi`` and ``w_lo``, ``kernel_weights(w)``) for a
    CUDA tensor, ``fc_tc_plain`` for a CPU tensor.  The kernel takes one
    TF32 product a step where ``torch.backends.cuda.matmul.allow_tf32``
    is set at the call: call it under ``exact_f32`` for f32 accuracy, as
    the package's entry points do."""
    if activation not in ACTS:
        raise ValueError(f"activation must be one of {tuple(ACTS)}, got "
                         f"{activation!r}")
    k = x.shape[-1]
    rows = x.reshape(math.prod(x.shape[:-1]), k).contiguous()
    if not x.is_cuda:            # the CUDA implementation checks its own
        _check(rows, w, w_hi, w_lo, bias, ACTS[activation])
    y = fc_op(rows, w, w_hi, w_lo, bias, ACTS[activation])
    return y.reshape(*x.shape[:-1], w.shape[0])
