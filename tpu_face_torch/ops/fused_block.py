"""A run of the detectors' identity-skip residual blocks,

    x <- relu(PW1x1(DW3x3_SAME(x) + bd) + bp + x)

layer after layer, as one kernel (``csrc/fused_dw_pw_block.cu``, which
replaces the Pallas prototypes ``docs/experiments/fused_block_prototype.py``
(K3, f32) and ``docs/experiments/fused_block_v2.py`` (K4, bf16
activations)).  Activations are NCHW ``[B, C, H, W]``, the layout the
lowered nets run in; weights are stacked per run: ``wd [L, C, 3, 3]``,
``bd [L, C]``, ``wp [L, C_out, C_in]``, ``bp [L, C]``.

``fused_blocks`` launches the kernel on a CUDA tensor or raises, and runs
``fused_blocks_plain`` (the per-op sequence the lowered net runs without
the kernel) on a CPU tensor.  ``LAUNCHES`` counts launches of the f32
entry point and ``BF16_LAUNCHES`` those of the bf16 one; the plain path
never adds to them.

The kernel stages a tile plus a halo of as many pixels as it runs layers
in shared memory, so the wrapper chooses, per run shape, the tile side and
the layers per launch (``plan``): more layers per launch cost recomputed
halo pixels, fewer cost a round trip of the activations through device
memory.
"""

import math

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0        # fused_dw_pw_block_f32
BF16_LAUNCHES = 0   # fused_dw_pw_block_bf16

SMEM_LIMIT = 232448      # opt-in shared memory per block on an H100
GROUP = 8                # output channels per thread in the kernel's 1x1
F32_FLOPS = 67e12        # H100 SXM f32 FMA peak (data sheet)
BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
FMA_SHARE = 0.3          # share of the f32 peak the plain FMA loops reach


def block_flops(c: int) -> int:
    """Operations of one block per pixel: the 3x3 depthwise and the 1x1
    (a multiply and an add per weight) and four per channel for the two
    biases, the residual add and the relu."""
    return 2 * (9 * c + c * c) + 4 * c


def smem_bytes(c: int, tile: int, layers: int) -> int:
    """Shared memory of one block: the staged activations and the
    depthwise output ([C, (tile + 2 layers)^2] f32 each) and the weights
    of every layer of the launch."""
    e = tile + 2 * layers
    return 4 * (2 * c * e * e + layers * (c * c + 11 * c))


def split_layers(layers: int, per_launch: int):
    """The layers of each launch: ``per_launch`` at a time, the rest
    last."""
    full, rest = divmod(layers, per_launch)
    return (per_launch,) * full + ((rest,) if rest else ())


def plan(c: int, h: int, w: int, layers: int, itemsize: int = 4):
    """(tile side, layers of each launch) for a run of ``layers`` blocks
    on [C, H, W] activations of ``itemsize`` bytes.

    Among the tiles (multiples of 4) that fit shared memory, it picks the
    one with the least modelled time per frame: the pixels computed,
    recomputed halo included, at ``FMA_SHARE`` of the f32 peak, plus one
    read and one write of the activations per launch; ties go to more
    layers per launch, then to the larger tile.  Deterministic, so a
    caller can count the launches a run will make."""
    if layers < 1:
        raise ValueError(f"layers must be >= 1, got {layers}")
    flops = block_flops(c)
    best = None
    for per_launch in range(layers, 0, -1):
        chunks = split_layers(layers, per_launch)
        fits = [t for t in range(4, max(h, w) + 4, 4)
                if smem_bytes(c, t, per_launch) <= SMEM_LIMIT]
        for tile in reversed(fits):
            tiles = math.ceil(h / tile) * math.ceil(w / tile)
            pixels = sum(tiles * (tile + 2 * (k - 1 - l)) ** 2
                         for k in chunks for l in range(k))
            cost = (pixels * flops / (F32_FLOPS * FMA_SHARE)
                    + len(chunks) * 2 * itemsize * c * h * w / BYTES_PER_S)
            if best is None or cost < best[0]:
                best = (cost, tile, chunks)
    if best is None:
        raise ValueError(f"no tile of C={c} fits {SMEM_LIMIT} bytes of "
                         f"shared memory")
    return best[1], best[2]


def _check(x, wd, bd, wp, bp):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    layers = wd.shape[0] if wd.dim() == 4 else -1
    if tuple(wd.shape) != (layers, c, 3, 3):
        raise ValueError(f"wd must be [L, {c}, 3, 3] (a 3x3 depthwise "
                         f"kernel per channel), got {tuple(wd.shape)}")
    if tuple(wp.shape) != (layers, c, c):
        raise ValueError(f"wp must be [L, {c}, {c}] (a C -> C 1x1), got "
                         f"{tuple(wp.shape)}")
    for name, t in (("bd", bd), ("bp", bp)):
        if tuple(t.shape) != (layers, c):
            raise ValueError(f"{name} must be [L, {c}], got "
                             f"{tuple(t.shape)}")
    if layers < 1:
        raise ValueError("a run needs at least one layer")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("wd", wd), ("bd", bd), ("wp", wp), ("bp", bp)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_blocks_plain(x, wd, bd, wp, bp):
    """Plain PyTorch version: per layer a depthwise ``F.conv2d`` (groups
    = C, padding 1), a 1x1 ``F.conv2d``, the residual add and the relu,
    the sequence ``TFLiteNet`` runs op by op.  In bf16 the weights are
    cast to bf16, every op's output is bf16 and each bias is added after
    its convolution as a separate op, as in the JAX reference
    ``xla_blocks`` of docs/experiments/fused_block_v2.py and in
    ``TFLiteNet``'s bf16 convolutions."""
    _check(x, wd, bd, wp, bp)
    c = x.shape[1]
    dt = x.dtype

    def conv(v, w, b, **kw):
        if dt == torch.float32:
            return F.conv2d(v, w, b, **kw)
        return F.conv2d(v, w.to(dt), None, **kw) + b.to(dt)[:, None, None]

    for l in range(wd.shape[0]):
        y = conv(x, wd[l, :, None], bd[l], padding=1, groups=c)
        z = conv(y, wp[l, :, :, None, None], bp[l])
        x = torch.relu(z + x)
    return x


def fused_blocks(x, wd, bd, wp, bp, tiling=None):
    """The run on x [B, C, H, W] (f32 or bf16): the CUDA kernel for a
    CUDA tensor, ``fused_blocks_plain`` for a CPU tensor.  ``tiling``
    ((tile, layers of each launch)) overrides ``plan``; it is for
    measuring other tilings."""
    global LAUNCHES, BF16_LAUNCHES
    _check(x, wd, bd, wp, bp)
    if x.device.type == "cpu":
        return fused_blocks_plain(x, wd, bd, wp, bp)
    if x.device.type != "cuda":
        raise ValueError(f"no fused block kernel for device {x.device}")
    b, c, h, w = x.shape
    if c % GROUP:
        raise ValueError(f"the kernel needs C % {GROUP} == 0, got C={c}")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535")
    tile, chunks = tiling or plan(c, h, w, wd.shape[0], x.element_size())
    if sum(chunks) != wd.shape[0]:
        raise ValueError(f"tiling {chunks} does not cover {wd.shape[0]} "
                         f"layers")
    if smem_bytes(c, tile, max(chunks)) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} with {max(chunks)} layers needs "
                         f"{smem_bytes(c, tile, max(chunks))} bytes of "
                         f"shared memory")
    # the kernel reads f32 weights, the 1x1 transposed ([L, C_in,
    # C_out]); in bf16 they carry bf16 values, as the plain version's do
    wd, bd, wpt, bp = (t.to(x.dtype).float().contiguous()
                       for t in (wd, bd, wp.transpose(1, 2), bp))
    bf16 = x.dtype == torch.bfloat16
    fn = getattr(_build.load("fused_dw_pw_block"),
                 "fused_dw_pw_block_bf16" if bf16
                 else "fused_dw_pw_block_f32")
    x = x.contiguous()
    if b * h * w == 0:
        return torch.empty_like(x)
    first = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for k in chunks:
            out = torch.empty_like(x)
            err = fn(x.data_ptr(), out.data_ptr(), wd[first].data_ptr(),
                     bd[first].data_ptr(), wpt[first].data_ptr(),
                     bp[first].data_ptr(), b, c, h, w, k, tile, stream)
            if err != 0:
                raise RuntimeError(f"fused_dw_pw_block launch failed: CUDA "
                                   f"error {err} (B={b} C={c} {h}x{w}, "
                                   f"{k} layers, tile {tile})")
            if bf16:
                BF16_LAUNCHES += 1
            else:
                LAUNCHES += 1
            x = out
            first += k
    return x
