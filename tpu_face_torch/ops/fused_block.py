"""A run of the detectors' identity-skip residual blocks,

    x <- relu(PW1x1(DW3x3_SAME(x) + bd) + bp + x)

layer after layer, as one kernel per launch: f32 activations go to
``csrc/fused_dw_pw_block.cu`` (which replaces the Pallas prototype
``docs/experiments/fused_block_prototype.py``, K3: the 1x1 in split
TF32 on the tensor cores), bf16 activations to
``csrc/fused_dw_pw_block_bf16.cu`` (which replaces
``docs/experiments/fused_block_v2.py``, K4: the 1x1 on the tensor
cores).  Activations are NCHW ``[B, C, H, W]``, the layout the lowered
nets run in; weights are stacked per run: ``wd [L, C, 3, 3]``,
``bd [L, C]``, ``wp [L, C_out, C_in]``, ``bp [L, C]``.

``fused_blocks`` launches the kernel on a CUDA tensor or raises, and runs
``fused_blocks_plain`` (the per-op sequence the lowered net runs without
the kernel) on a CPU tensor.  Each kernel reads its weights in its own
form (``kernel_weights``: one packed blob per layer, ``pack_f32`` and
``pack_bf16``); a caller that runs the same weights again
(``TFLiteNet``) makes that form once and passes it.
``LAUNCHES`` counts launches of the f32 kernel and ``BF16_LAUNCHES``
those of the bf16 one; the plain path never adds to them.

A run is the registered operator ``torch.ops.tpu_face_torch.fused_blocks``
(``fused_op``: x, the packed weights, the tile and the layers of each
launch): its CUDA implementation launches the kernel of x's type once
per chunk of layers, its CPU implementation unpacks the weights and runs
the plain version, and its fake implementation gives ``torch.export`` the
output's shape, so an exported net holds one node per run.
``fused_blocks`` validates, plans and packs, then calls it.

Both kernels stage a tile plus a halo of as many pixels as they run
layers in shared memory, so the wrapper chooses, per run shape, the tile
side and the layers per launch (``plan``, each kernel with its own
shared-memory formula and cost model): more layers per launch cost
recomputed halo pixels, fewer cost a round trip of the activations
through device memory.

``fused_blocks_tf32x3`` emulates on the CPU the f32 kernel's split-TF32
1x1 (it runs on no path: the tests hold it to the plain version, and the
card's check against the plain version is the one that decides).
"""

import math

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0        # fused_dw_pw_block.cu (f32)
BF16_LAUNCHES = 0   # fused_dw_pw_block_bf16.cu

SMEM_LIMIT = 232448      # opt-in shared memory per block on an H100
# The f32 kernel's time model (f32_cost): one CTA's seconds per
# pixel-channel it computes and per pixel-channel it stages or writes
# back (as the bf16 kernel's below), per weight it fetches for a layer,
# and per CTA.  Fitted by least squares (relative error) to the device
# times of every tiling of the BACK detector's four runs at batch 64 on
# an H100 SXM; with them plan picks each run's tiling within 5% of the
# fastest.
F32_PX_S = 4.08e-10
F32_STAGE_S = 2.10e-10
F32_WEIGHT_S = 5.58e-10
F32_CTA_S = 4.34e-6
F32_CTAS_PER_SM = 2      # __launch_bounds__(256, 2)
# The bf16 kernel's time model (bf16_cost): one CTA's seconds per
# pixel-channel it computes (a layer's depthwise, 1x1 and epilogue) and
# per pixel-channel it stages in or writes back, with 1 or
# BF16_CTAS_PER_SM CTAs sharing an SM.  Fitted by least squares (relative
# error) to the device times of every tiling of the BACK detector's four
# runs at batch 64 on an H100 SXM (199 tilings); with them plan picks
# each run's tiling within 5% of the fastest.
BF16_PX_S = 4.75e-10
BF16_STAGE_S = 4.47e-10
BF16_CTAS_PER_SM = 2     # __launch_bounds__(256, 2): its registers allow 2
SMS = 132                # H100 SXM
SM_SMEM = 233472         # shared memory per SM on an H100
CTA_SMEM_RESERVED = 1024  # per resident CTA
# channel counts both kernels are instantiated for: those of the
# detectors' residual runs (BACK, FRONT and SHORT)
CHANNELS = (24, 48, 96)


def block_flops(c: int) -> int:
    """Operations of one block per pixel: the 3x3 depthwise and the 1x1
    (a multiply and an add per weight) and four per channel for the two
    biases, the residual add and the relu."""
    return 2 * (9 * c + c * c) + 4 * c


def blob_floats(c: int) -> int:
    """Floats of one layer's packed f32 weights (``pack_f32``)."""
    return c * (c + 4) + 11 * c


def _box(tile: int, layers: int, h: int, w: int) -> int:
    """Pixels of a staged box: tile + 2 layers per side, clipped to the
    image and its one-pixel border."""
    e = tile + 2 * layers
    return min(e, h + 2) * min(e, w + 2)


def pixel_floats(c: int) -> int:
    """Floats per staged pixel of the f32 kernel: c + 2 where a lane owns
    four pixels (c <= 48), c + 4 where it owns two (the padding keeps a
    warp's loads in distinct banks)."""
    return c + 2 if c <= 48 else c + 4


def smem_bytes(c: int, tile: int, layers: int, h: int, w: int) -> int:
    """Shared memory of one block of the f32 kernel: two f32 buffers of
    the staged box (``_box``), ``pixel_floats(c)`` per pixel, and two
    layers' packed weights."""
    return (8 * _box(tile, layers, h, w) * pixel_floats(c)
            + 8 * blob_floats(c))


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
    return 8 * _box(tile, layers, h, w) * (c // 2 + 2) + 2 * blob_bytes(c)


def split_layers(layers: int, per_launch: int):
    """The layers of each launch: ``per_launch`` at a time, the rest
    last."""
    full, rest = divmod(layers, per_launch)
    return (per_launch,) * full + ((rest,) if rest else ())


def plan(c: int, h: int, w: int, layers: int, itemsize: int = 4):
    """(tile side, layers of each launch) for a run of ``layers`` blocks
    on [C, H, W] activations of ``itemsize`` bytes: 4 for the f32
    kernel, 2 for the bf16 kernel.

    Among the even tiles whose staged boxes fit shared memory (the
    kernel's own formula, ``smem_bytes`` or ``smem_bytes_bf16``), the
    least modelled time (``f32_cost`` or ``bf16_cost``); ties go to more
    layers per launch, then to the larger tile.  Deterministic, so a
    caller can count the launches a run will make."""
    if layers < 1:
        raise ValueError(f"layers must be >= 1, got {layers}")
    smem, cost = ((smem_bytes_bf16, bf16_cost) if itemsize == 2
                  else (smem_bytes, f32_cost))
    best = None
    for per_launch in range(layers, 0, -1):
        chunks = split_layers(layers, per_launch)
        for tile in range(max(h, w) + max(h, w) % 2, 0, -2):
            if smem(c, tile, per_launch, h, w) > SMEM_LIMIT:
                continue
            t = cost(c, h, w, tile, chunks)
            if best is None or t < best[0]:
                best = (t, tile, chunks)
    if best is None:
        raise ValueError(f"no tile of C={c} fits {SMEM_LIMIT} bytes of "
                         f"shared memory")
    return best[1], best[2]


def _spans(n: int, tile: int, layers: int, unit: int = 1):
    """Per layer l of a launch of ``layers``, the summed lengths along an
    axis of n pixels of every tile's computed span (the tile grown by
    ``layers - 1 - l`` on each side, within the image: the kernels
    compute only in-image pixels), each rounded up to ``unit`` pixels."""
    return [sum(-(-(min(t0 + tile + g, n) - max(t0 - g, 0)) // unit) * unit
                for t0 in range(0, n, tile))
            for g in range(layers - 1, -1, -1)]


def _ctas_per_sm(smem: int, most: int) -> int:
    """CTAs resident on one SM with ``smem`` bytes each, at most
    ``most``."""
    return max(1, min(most, SM_SMEM // (smem + CTA_SMEM_RESERVED)))


def bf16_ctas_per_sm(c: int, tile: int, layers: int, h: int, w: int) -> int:
    """CTAs of the bf16 kernel resident on one SM at this tiling: as many
    as its shared memory allows, at most ``BF16_CTAS_PER_SM``."""
    return _ctas_per_sm(smem_bytes_bf16(c, tile, layers, h, w),
                        BF16_CTAS_PER_SM)


def f32_ctas_per_sm(c: int, tile: int, layers: int, h: int, w: int) -> int:
    """CTAs of the f32 kernel resident on one SM at this tiling: as many
    as its shared memory allows, at most ``F32_CTAS_PER_SM``."""
    return _ctas_per_sm(smem_bytes(c, tile, layers, h, w), F32_CTAS_PER_SM)


def _cost(c, h, w, tile, chunks, px_s, stage_s, ctas_per_sm, unit=2,
          weight_s=0.0, cta_s=0.0, blob=0) -> float:
    """Modelled seconds per frame of a kernel on a run of ``sum(chunks)``
    layers at ``tile``, ``chunks`` layers per launch.  Per launch, its
    CTAs' work spread over the SMs: every computed pixel-channel
    (recomputed halo included; along x in groups of ``unit`` pixels) at
    ``px_s``, every staged one (halo and one-pixel image border included,
    and the tile written back) at ``stage_s``, each CTA's fetch of
    ``blob`` weights per layer at ``weight_s`` each and each CTA at
    ``cta_s``, each CTA taking an SM's share of 1 / ``ctas_per_sm(...)``,
    so a tiling whose shared memory leaves one CTA per SM where two fit
    otherwise runs at half the rate."""
    cost = 0.0
    for k in chunks:
        pixels = sum(r * s for r, s in zip(_spans(h, tile, k),
                                           _spans(w, tile, k, unit)))
        box = math.prod(sum(min(t0 + tile + k, n + 1) - max(t0 - k, -1)
                            for t0 in range(0, n, tile)) for n in (h, w))
        ctas = math.ceil(h / tile) * math.ceil(w / tile)
        cost += (c * (pixels * px_s + (box + h * w) * stage_s)
                 + ctas * (k * blob * weight_s + cta_s)) / (
            SMS * ctas_per_sm(c, tile, k, h, w))
    return cost


def bf16_cost(c: int, h: int, w: int, tile: int, chunks) -> float:
    """``_cost`` of the bf16 kernel (``BF16_PX_S``, ``BF16_STAGE_S``,
    ``bf16_ctas_per_sm``; its lanes compute pixel pairs)."""
    return _cost(c, h, w, tile, chunks, BF16_PX_S, BF16_STAGE_S,
                 bf16_ctas_per_sm)


def f32_cost(c: int, h: int, w: int, tile: int, chunks) -> float:
    """``_cost`` of the f32 kernel (``F32_*``, ``f32_ctas_per_sm``; its
    lanes compute groups of four pixels for C <= 48, pairs above)."""
    return _cost(c, h, w, tile, chunks, F32_PX_S, F32_STAGE_S,
                 f32_ctas_per_sm, 4 if c <= 48 else 2, F32_WEIGHT_S,
                 F32_CTA_S, blob_floats(c))


def pack_f32(wd, bd, wp, bp):
    """A run's weights as the f32 kernel reads them, one row of
    ``blob_floats(C)`` floats per layer (f32 [L, blob_floats(C)], on the
    weights' device): the 1x1 transposed, [C_in][C + 4] (zero padding
    columns), then the depthwise taps [9][C], bd [C] and bp [C]."""
    layers, c = bd.shape
    wpt = torch.zeros(layers, c, c + 4, dtype=torch.float32,
                      device=wp.device)
    wpt[:, :, :c] = wp.transpose(1, 2)
    taps = wd.float().reshape(layers, c, 9).transpose(1, 2)
    return torch.cat([wpt.reshape(layers, -1), taps.reshape(layers, 9 * c),
                      bd.float(), bp.float()], 1).contiguous()


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


def unpack_f32(packed, c: int):
    """(wd [L, C, 3, 3], bd [L, C], wp [L, C, C], bp [L, C]) f32 from
    ``pack_f32``'s rows: the inverse of the packing, exact."""
    layers = packed.shape[0]
    n = c * (c + 4)
    wp = packed[:, :n].reshape(layers, c, c + 4)[:, :, :c].transpose(1, 2)
    wd = packed[:, n:n + 9 * c].reshape(layers, 9, c).transpose(1, 2)
    return (wd.reshape(layers, c, 3, 3).contiguous(),
            packed[:, n + 9 * c:n + 10 * c].contiguous(), wp.contiguous(),
            packed[:, n + 10 * c:].contiguous())


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
    ``dtype`` reads: (``pack_f32(...)``,) for float32, (``pack_bf16(...)``,)
    for bfloat16."""
    if dtype == torch.bfloat16:
        return (pack_bf16(wd, bd, wp, bp),)
    return (pack_f32(wd, bd, wp, bp),)


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


def tf32_split(v):
    """(hi, lo) f32 tensors with v ~ hi + lo, each a TF32 value (10
    explicit significand bits) rounded to nearest, ties away from zero,
    as the f32 kernel's cvt.rna.tf32.f32: hi = tf32(v), lo = tf32(v - hi)."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def fused_blocks_tf32x3(x, wd, bd, wp, bp):
    """CPU emulation of the f32 kernel's split-TF32 1x1 on f32 x: the
    plain version with each 1x1 as the kernel computes it, lo(y) hi(w) +
    hi(y) lo(w) + hi(y) hi(w) (``tf32_split``; each product exact in f32)
    summed in f32.  It runs on no path."""
    _check(x, wd, bd, wp, bp)
    c = x.shape[1]
    for l in range(wd.shape[0]):
        y = F.conv2d(x, wd[l, :, None], bd[l], padding=1, groups=c)
        yh, yl = tf32_split(y)
        wh, wl = tf32_split(wp[l].float())
        z = F.conv2d(torch.cat([yl, yh, yh], 1),
                     torch.cat([wh, wl, wh], 1)[:, :, None, None], bp[l])
        x = torch.relu(z + x)
    return x


def _weights_form(x, layers):
    """[(shape, dtype)] of ``kernel_weights(..., x.dtype)`` for a run of
    ``layers`` on x."""
    c = x.shape[1]
    if x.dtype == torch.bfloat16:
        return [((layers, blob_bytes(c)), torch.uint8)]
    return [((layers, blob_floats(c)), torch.float32)]


def _fused_cpu(x, packed, tile, chunks):
    """The run operator's CPU implementation: the plain version on the
    unpacked weights (the packing is exact, so bit for bit that on the
    raw weights)."""
    unpack = unpack_bf16 if x.dtype == torch.bfloat16 else unpack_f32
    return fused_blocks_plain(x, *unpack(packed, x.shape[1]))


def _fused_cuda(x, packed, tile, chunks):
    """One launch of the kernel of x's type per chunk of layers."""
    global LAUNCHES, BF16_LAUNCHES
    b, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    if c not in CHANNELS:
        raise ValueError(f"the kernels are built for C in {CHANNELS}, got "
                         f"C={c}")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535")
    need = (smem_bytes_bf16 if bf16 else smem_bytes)(c, tile, max(chunks),
                                                     h, w)
    if need > SMEM_LIMIT:
        raise ValueError(f"tile {tile} with {max(chunks)} layers needs "
                         f"{need} bytes of shared memory")
    if [(tuple(packed.shape), packed.dtype)] != _weights_form(
            x, sum(chunks)) or packed.device != x.device or \
            not packed.is_contiguous():
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
        _build.launch(fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                      packed[first].data_ptr(), b, c, h, w, k, tile)
        if bf16:
            BF16_LAUNCHES += 1
        else:
            LAUNCHES += 1
        x = out
        first += k
    return x


def _fused_fake(x, packed, tile, chunks):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# the run on x [B, C, H, W] with the weights of ``kernel_weights``
# (``packed``), the tile and the layers of each launch (``chunks``)
fused_op = _build.register(
    "fused_blocks", "(Tensor x, Tensor packed, int tile, int[] chunks) -> "
    "Tensor", _fused_cpu, _fused_cuda, _fused_fake)


def fused_blocks(x, wd, bd, wp, bp, tiling=None, weights=None):
    """The run on x [B, C, H, W] (f32 or bf16): the CUDA kernel of its
    type for a CUDA tensor, ``fused_blocks_plain`` for a CPU tensor, both
    through the operator ``fused_op``.  ``tiling`` ((tile, layers of each
    launch)) overrides ``plan``; ``weights`` is ``kernel_weights(wd, bd,
    wp, bp, x.dtype)`` made once by the caller (made here when None)."""
    _check(x, wd, bd, wp, bp)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused block kernel for device {x.device}")
    b, c, h, w = x.shape
    layers = wd.shape[0]
    tile, chunks = tiling or plan(c, h, w, layers, x.element_size())
    if sum(chunks) != layers:
        raise ValueError(f"tiling {chunks} does not cover {layers} layers")
    if weights is None:
        weights = kernel_weights(wd, bd, wp, bp, x.dtype)
    if [(tuple(t.shape), t.dtype) for t in weights] != _weights_form(
            x, layers) or any(t.device != x.device for t in weights):
        raise ValueError(f"weights must be kernel_weights(..., {x.dtype}) "
                         f"on {x.device}")
    (packed,) = weights
    return fused_op(x, packed, int(tile), [int(k) for k in chunks])
