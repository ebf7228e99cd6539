"""A run of the detectors' identity-skip residual blocks,

    x <- relu(PW1x1(DW3x3_SAME(x) + bd) + bp + x)

layer after layer, as one kernel per launch: f32 activations go to
``csrc/fused_dw_pw_block.cu`` (which replaces the Pallas prototype
``docs/experiments/fused_block_prototype.py``, K3), bf16 activations to
``csrc/fused_dw_pw_block_bf16.cu`` (which replaces
``docs/experiments/fused_block_v2.py``, K4: the 1x1 on the tensor
cores).  Activations are NCHW ``[B, C, H, W]``, the layout the lowered
nets run in; weights are stacked per run: ``wd [L, C, 3, 3]``,
``bd [L, C]``, ``wp [L, C_out, C_in]``, ``bp [L, C]``.

``fused_blocks`` launches the kernel on a CUDA tensor or raises, and runs
``fused_blocks_plain`` (the per-op sequence the lowered net runs without
the kernel) on a CPU tensor.  Each kernel reads its weights in its own
form (``kernel_weights``: the f32 kernel the 1x1 transposed, the bf16
kernel one packed blob per layer, ``pack_bf16``); a caller that runs the
same weights again (``TFLiteNet``) makes that form once and passes it.
``LAUNCHES`` counts launches of the f32 kernel and ``BF16_LAUNCHES``
those of the bf16 one; the plain path never adds to them.

Both kernels stage a tile plus a halo of as many pixels as they run
layers in shared memory, so the wrapper chooses, per run shape, the tile
side and the layers per launch (``plan``, each kernel with its own
shared-memory formula and cost model): more layers per launch cost
recomputed halo pixels, fewer cost a round trip of the activations
through device memory.
"""

import math

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0        # fused_dw_pw_block.cu (f32)
BF16_LAUNCHES = 0   # fused_dw_pw_block_bf16.cu

SMEM_LIMIT = 232448      # opt-in shared memory per block on an H100
GROUP = 8                # output channels per thread in the f32 kernel's 1x1
F32_FLOPS = 67e12        # H100 SXM f32 FMA peak (data sheet)
BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
FMA_SHARE = 0.3          # share of the f32 peak the f32 kernel's FMA loops reach
# The bf16 kernel's time model (bf16_cost): one CTA's seconds per
# pixel-channel it computes (a layer's depthwise, 1x1 and epilogue) and
# per pixel-channel it stages in or writes back, with 1 or
# BF16_CTAS_PER_SM CTAs sharing an SM.  Fitted by least squares (relative
# error) to chip_smoke.py --sweep's device times of the BACK detector's
# four runs at batch 64 on an H100 SXM (199 tilings); with them plan picks
# each run's tiling within 5% of the sweep's best.
BF16_PX_S = 4.75e-10
BF16_STAGE_S = 4.47e-10
BF16_CTAS_PER_SM = 2     # __launch_bounds__(256, 2): its registers allow 2
SMS = 132                # H100 SXM
SM_SMEM = 233472         # shared memory per SM on an H100
CTA_SMEM_RESERVED = 1024  # per resident CTA
# channel counts the bf16 kernel is instantiated for: those of the
# detectors' residual runs (BACK, FRONT and SHORT)
BF16_CHANNELS = (24, 48, 96)


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


def weight_stride(c: int) -> int:
    """Row stride (elements) of the bf16 kernel's packed 1x1: the eight
    rows one mma B fragment reads fall in distinct shared-memory banks."""
    return c + 8 if c % 16 == 0 else c


def blob_bytes(c: int) -> int:
    """Bytes of one layer's packed weights (``pack_bf16``)."""
    return 2 * c * weight_stride(c) + 44 * c


def smem_bytes_bf16(c: int, tile: int, layers: int, h: int, w: int) -> int:
    """Shared memory of one block of the bf16 kernel: two bf16 buffers of
    the staged box (tile + 2 layers per side, clipped to the image and
    its one-pixel border), c/2 + 2 words per pixel, and two layers'
    packed weights."""
    e = tile + 2 * layers
    return (8 * min(e, h + 2) * min(e, w + 2) * (c // 2 + 2)
            + 2 * blob_bytes(c))


def split_layers(layers: int, per_launch: int):
    """The layers of each launch: ``per_launch`` at a time, the rest
    last."""
    full, rest = divmod(layers, per_launch)
    return (per_launch,) * full + ((rest,) if rest else ())


def plan(c: int, h: int, w: int, layers: int, itemsize: int = 4):
    """(tile side, layers of each launch) for a run of ``layers`` blocks
    on [C, H, W] activations of ``itemsize`` bytes: 4 for the f32
    kernel, 2 for the bf16 kernel (``_plan_bf16``).

    For the f32 kernel, among the tiles (multiples of 4) that fit shared
    memory, it picks the one with the least modelled time per frame: the
    pixels computed,
    recomputed halo included, at ``FMA_SHARE`` of the f32 peak, plus one
    read and one write of the activations per launch; ties go to more
    layers per launch, then to the larger tile.  Deterministic, so a
    caller can count the launches a run will make."""
    if layers < 1:
        raise ValueError(f"layers must be >= 1, got {layers}")
    if itemsize == 2:
        return _plan_bf16(c, h, w, layers)
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


def _spans(n: int, tile: int, layers: int, unit: int = 1):
    """Per layer l of a launch of ``layers``, the summed lengths along an
    axis of n pixels of every tile's computed span (the tile grown by
    ``layers - 1 - l`` on each side, within the image: the bf16 kernel
    computes only in-image pixels), each rounded up to ``unit`` pixels."""
    return [sum(-(-(min(t0 + tile + g, n) - max(t0 - g, 0)) // unit) * unit
                for t0 in range(0, n, tile))
            for g in range(layers - 1, -1, -1)]


def bf16_ctas_per_sm(c: int, tile: int, layers: int, h: int, w: int) -> int:
    """CTAs of the bf16 kernel resident on one SM at this tiling: as many
    as its shared memory allows, at most ``BF16_CTAS_PER_SM``."""
    need = smem_bytes_bf16(c, tile, layers, h, w) + CTA_SMEM_RESERVED
    return max(1, min(BF16_CTAS_PER_SM, SM_SMEM // need))


def bf16_cost(c: int, h: int, w: int, tile: int, chunks) -> float:
    """Modelled seconds per frame of the bf16 kernel on a run of
    ``sum(chunks)`` layers at ``tile``, ``chunks`` layers per launch.
    Per launch, its CTAs' work spread over the SMs: every computed
    pixel-channel (recomputed halo included; along x in pairs) at
    ``BF16_PX_S`` and every staged one (halo and one-pixel image border
    included, and the tile written back) at ``BF16_STAGE_S``, each CTA
    taking an SM's share of 1 / ``bf16_ctas_per_sm``, so a tiling whose
    shared memory leaves one CTA per SM runs at half the rate."""
    cost = 0.0
    for k in chunks:
        pixels = sum(r * s for r, s in zip(_spans(h, tile, k),
                                           _spans(w, tile, k, 2)))
        box = math.prod(sum(min(t0 + tile + k, n + 1) - max(t0 - k, -1)
                            for t0 in range(0, n, tile)) for n in (h, w))
        cost += c * (pixels * BF16_PX_S + (box + h * w) * BF16_STAGE_S) / (
            SMS * bf16_ctas_per_sm(c, tile, k, h, w))
    return cost


def _plan_bf16(c: int, h: int, w: int, layers: int):
    """``plan`` for the bf16 kernel: among the even tiles whose staged
    boxes fit shared memory (``smem_bytes_bf16``), the least
    ``bf16_cost``; ties go to more layers per launch, then to the larger
    tile."""
    best = None
    for per_launch in range(layers, 0, -1):
        chunks = split_layers(layers, per_launch)
        for tile in range(max(h, w) + max(h, w) % 2, 0, -2):
            if smem_bytes_bf16(c, tile, per_launch, h, w) > SMEM_LIMIT:
                continue
            cost = bf16_cost(c, h, w, tile, chunks)
            if best is None or cost < best[0]:
                best = (cost, tile, chunks)
    if best is None:
        raise ValueError(f"no tile of C={c} fits {SMEM_LIMIT} bytes of "
                         f"shared memory")
    return best[1], best[2]


def pack_bf16(wd, bd, wp, bp):
    """A run's weights as the bf16 kernel reads them, one row of
    ``blob_bytes(C)`` bytes per layer (uint8 [L, blob_bytes(C)], on the
    weights' device): the 1x1 [C_out][weight_stride(C)] in bf16 (zero
    padding columns), then the depthwise taps [9][C], bd [C] and bp [C]
    in f32, every value rounded to bf16 as the plain version casts it."""
    layers, c = bd.shape
    bf16 = torch.bfloat16
    wpp = torch.zeros(layers, c, weight_stride(c), dtype=bf16,
                      device=wp.device)
    wpp[:, :, :c] = wp.to(bf16)
    taps = wd.to(bf16).float().reshape(layers, c, 9).transpose(1, 2)
    f32 = torch.cat([taps.reshape(layers, 9 * c), bd.to(bf16).float(),
                     bp.to(bf16).float()], 1)
    return torch.cat([wpp.reshape(layers, -1).view(torch.uint8),
                      f32.contiguous().view(torch.uint8)], 1).contiguous()


def unpack_bf16(packed, c: int):
    """(wd [L, C, 3, 3], bd [L, C], wp [L, C, C], bp [L, C]) f32 from
    ``pack_bf16``'s rows: the inverse of the packing."""
    layers = packed.shape[0]
    n = 2 * c * weight_stride(c)
    wp = packed[:, :n].contiguous().view(torch.bfloat16).reshape(
        layers, c, weight_stride(c))[:, :, :c].float()
    f32 = packed[:, n:].contiguous().view(torch.float32)
    wd = f32[:, :9 * c].reshape(layers, 9, c).transpose(1, 2).reshape(
        layers, c, 3, 3)
    return wd, f32[:, 9 * c:10 * c], wp, f32[:, 10 * c:]


def kernel_weights(wd, bd, wp, bp, dtype):
    """The run's weights in the form the kernel for activations of
    ``dtype`` reads: for float32 (wd, bd, the 1x1 transposed [L, C_in,
    C_out], bp) in f32, contiguous; for bfloat16 (``pack_bf16(...)``,)."""
    if dtype == torch.bfloat16:
        return (pack_bf16(wd, bd, wp, bp),)
    return tuple(t.float().contiguous()
                 for t in (wd, bd, wp.transpose(1, 2), bp))


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


def fused_blocks(x, wd, bd, wp, bp, tiling=None, weights=None):
    """The run on x [B, C, H, W] (f32 or bf16): the CUDA kernel of its
    type for a CUDA tensor, ``fused_blocks_plain`` for a CPU tensor.
    ``tiling`` ((tile, layers of each launch)) overrides ``plan``;
    ``weights`` is ``kernel_weights(wd, bd, wp, bp, x.dtype)`` made once
    by the caller (made here when None)."""
    global LAUNCHES, BF16_LAUNCHES
    _check(x, wd, bd, wp, bp)
    if x.device.type == "cpu":
        return fused_blocks_plain(x, wd, bd, wp, bp)
    if x.device.type != "cuda":
        raise ValueError(f"no fused block kernel for device {x.device}")
    b, c, h, w = x.shape
    layers = wd.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and c not in BF16_CHANNELS:
        raise ValueError(f"the bf16 kernel is built for C in "
                         f"{BF16_CHANNELS}, got C={c}")
    if c % GROUP:
        raise ValueError(f"the kernel needs C % {GROUP} == 0, got C={c}")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535")
    tile, chunks = tiling or plan(c, h, w, layers, x.element_size())
    if sum(chunks) != layers:
        raise ValueError(f"tiling {chunks} does not cover {layers} layers")
    need = (smem_bytes_bf16(c, tile, max(chunks), h, w) if bf16
            else smem_bytes(c, tile, max(chunks)))
    if need > SMEM_LIMIT:
        raise ValueError(f"tile {tile} with {max(chunks)} layers needs "
                         f"{need} bytes of shared memory")
    if weights is None:
        weights = kernel_weights(wd, bd, wp, bp, x.dtype)
    want = ([(layers, blob_bytes(c))] if bf16 else
            [(layers, c, 3, 3), (layers, c), (layers, c, c), (layers, c)])
    if [tuple(t.shape) for t in weights] != want or any(
            t.device != x.device or not t.is_contiguous() for t in weights):
        raise ValueError(f"weights must be kernel_weights(..., {x.dtype}) "
                         f"on {x.device}")
    fn = (_build.entry("fused_dw_pw_block_bf16", "fused_dw_pw_block_bf16")
          if bf16 else
          _build.entry("fused_dw_pw_block", "fused_dw_pw_block_f32"))
    x = x.contiguous()
    if b * h * w == 0:
        return torch.empty_like(x)
    first = 0
    for k in chunks:
        out = torch.empty_like(x)
        ptrs = [t[first].data_ptr() for t in weights]
        _build.launch(fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                      *ptrs, b, c, h, w, k, tile)
        if bf16:
            BF16_LAUNCHES += 1
        else:
            LAUNCHES += 1
        x = out
        first += k
    return x
