"""The cascade's rotated-ROI warp: bilinear sampling of several
coordinate grids from one frame's channel planes in one kernel launch.

Counterpart of tpu_face/ops/pallas_warp.py, with both of its kernels:

* f32 planes go to ``warp_bilinear_segments`` (``csrc/warp_bilinear.cu``,
  which replaces the resident-plane Pallas ``_warp_kernel``; it takes the
  grids of a call as a table of segments, so their coordinates are never
  concatenated; ``warp_bilinear`` is its one-segment call);
* bf16 planes go to ``warp_bilinear_strips``
  (``csrc/warp_bilinear_strips.cu``, which replaces the HBM strip-DMA
  Pallas ``_warp_kernel_strips``; it also takes f32 planes).

``warp_sample_multi`` (the cascade) dispatches on the plane type as the
JAX version dispatches on a list of planes versus one stacked array; the
standalone models' ``image.warp_image_to_tensor`` calls the wrappers
itself and sends f32 planes to the strip kernel beyond the residency rule
(``planes_fit_vmem``).  On a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs its plain PyTorch version.  The kernels have no static sampling
window, so unlike the TPU kernels they need no envelope check: every ROI
is sampled exactly.

``warp_bilinear_strips_staged`` computes the same function as
``warp_bilinear_strips`` with each output block's source window staged
in shared memory (``csrc/warp_strips_staged.cu``), the TPU design: with
one copy of all three channels per block (``copies="fused"``, as
``_warp_kernel_strips``) or three per-channel copies (``"split"``, the
A/B baseline of ``tools/tpu_strip_dma_probe.py``).  The cascade does not
call it: it is the measured counterpart of the gather kernel.

The two kernels on the package's path are registered PyTorch operators,
``torch.ops.tpu_face_torch.warp_bilinear_segments`` and
``torch.ops.tpu_face_torch.warp_bilinear_strips``: their CPU
implementation is the plain version, their CUDA implementation the
kernel's launch, and a fake implementation gives ``torch.export`` the
output's shape, so an exported program (``tpu_face_torch.aot``) holds one
operator node per launch.  The public wrappers validate their arguments
and call the operator: the eager path and an exported program launch the
same code.

``LAUNCHES``, ``STRIP_LAUNCHES`` and ``STAGED_LAUNCHES`` count kernel
launches (the plain paths never add to them), so a run can show that the
main path went through the kernels.
"""

import math
import struct

import torch

from . import _build

LAUNCHES = 0          # warp_bilinear.cu
STRIP_LAUNCHES = 0    # warp_bilinear_strips.cu
STAGED_LAUNCHES = {"fused": 0, "split": 0}   # warp_strips_staged.cu

MAX_SEGMENTS = 4      # grids per launch of warp_bilinear.cu
# Row length warp_bilinear.cu gives a flat coordinate row whose grid
# shape the caller does not give: its 16 x 16 tiles are then runs of 256
# consecutive pixels.
FLAT_WIDTH = 16

# Shared memory of one of the staged kernel's two window buffers (all
# three channels): 12 KiB holds a block's bf16 window at up to ~2.5x
# downsampling and keeps the CTA small, so that many CTAs' copies are in
# flight on an SM (the fastest of four block geometries and budgets timed
# on an H100).  A block whose window does not fit reads the rest of its
# taps from global memory.
STAGE_BYTES = 12 * 1024
# (rt, cw): output rows and columns of one block of the staged kernel,
# one thread per output pixel
STAGED_BLOCK = (8, 16)

XWIN = 128            # the TPU kernel's x-window (lanes)
XLOAD = 2 * XWIN      # its aligned strip load width


def padded_width(w: int) -> int:
    """Padded plane width the TPU kernels allocate for a frame of width
    ``w`` (copy of ``pallas_warp.padded_width``; the card's planes are
    not padded, the rule only feeds ``planes_fit_vmem``)."""
    return max(-(-w // XWIN) * XWIN, XLOAD)


def planes_fit_vmem(h: int, w: int, budget_bytes: int = 12 * 2**20,
                    itemsize: int = 4) -> bool:
    """Whether three padded planes fit the TPU kernel's VMEM residency
    budget (copy of ``pallas_warp.planes_fit_vmem``): the rule that
    routes a frame size to the resident kernel or to the strip kernel."""
    hp = -(-h // 8) * 8
    return 3 * itemsize * hp * padded_width(w) <= budget_bytes


def make_planes(images, layout: str = "hwc", dtype=torch.float32):
    """[B, 3, H, W] contiguous channel planes of a frame batch ([B, H,
    W, 3] for ``layout="hwc"``, [B, 3, H, W] for "planar"), built once
    per batch and shared by every warp of it.  ``dtype`` is float32 or
    bfloat16; uint8 frames convert to bf16 directly, exactly (every
    uint8 value is a bf16 value; JAX pads in f32 and casts last and gets
    the same numbers).  Unlike the TPU kernels' planes they are not
    padded."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plane dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    if layout == "hwc":
        images = images.permute(0, 3, 1, 2)
    elif layout != "planar":
        raise ValueError(f"layout {layout!r}")
    return images.to(dtype).contiguous()


def warp_bilinear_plain(planes, xs, ys):
    """Plain PyTorch version of ``warp_bilinear.cu``: zero-border
    bilinear samples (tpu_face/ops/image.py::bilinear_sample) of planes
    [B, 3, H, W] at xs/ys [B, P], each tap widened to f32 as it is
    gathered.  Returns [B, 3, P] f32, channel-major like the kernels."""
    b, c, h, w = planes.shape
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    dx = (xs - x0f)[:, None]
    dy = (ys - y0f)[:, None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = planes.reshape(b, c, h * w)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 2, lin[:, None].expand(b, c, -1))
        return torch.where(valid[:, None], vals.to(torch.float32), 0.0)

    top = tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx
    bot = tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx
    return top * (1 - dy) + bot * dy


def warp_bilinear_strips_plain(planes, xs, ys):
    """Plain PyTorch version of ``warp_bilinear_strips.cu``: samples
    [B, 3, P] f32 of bf16 or f32 planes [B, 3, H, W] at xs/ys [B, P],
    each tap upcast to f32 before the blend (the same function as
    ``warp_bilinear_plain``, which widens every tap)."""
    return warp_bilinear_plain(planes, xs, ys)


def _check_planes(planes, plane_dtypes):
    if planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"planes must be [B, 3, H, W], got "
                         f"{tuple(planes.shape)}")
    if planes.dtype not in plane_dtypes:
        raise TypeError(f"planes must be one of {plane_dtypes}, got "
                        f"{planes.dtype}")


def _check_coords(planes, xs, ys, grid=False):
    """xs/ys: [B, P] (``grid``: [B, ...]) f32 on the planes' device.
    Cheap tensor attributes only: this runs on every launch."""
    if (xs.dim() < 2 if grid else xs.dim() != 2) or xs.shape != ys.shape \
            or xs.shape[0] != planes.shape[0]:
        raise ValueError(f"xs/ys must be [B, {'...' if grid else 'P'}] "
                         f"with B = "
                         f"{planes.shape[0]}, got {tuple(xs.shape)} and "
                         f"{tuple(ys.shape)}")
    for name, t in (("xs", xs), ("ys", ys)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.is_cuda != planes.is_cuda or \
                t.get_device() != planes.get_device():
            raise ValueError(f"{name} is on {t.device}, planes on "
                             f"{planes.device}")


def _check(planes, xs, ys, plane_dtypes):
    _check_planes(planes, plane_dtypes)
    _check_coords(planes, xs, ys)


def _cuda_planes(planes, p):
    """The checks every warp kernel makes on CUDA planes and P output
    pixels per frame."""
    if not planes.is_cuda:
        raise ValueError(f"no warp kernel for device {planes.device}")
    if planes.stride(3) != 1:
        raise ValueError("planes need unit stride along W")
    b, _, h, w = planes.shape
    if b > 65535 or p >= 2**30 or max(h, w) >= 2**24:
        raise ValueError(f"warp too large: B={b} P={p} H={h} W={w}")


def warp_bilinear_segments_plain(planes, segments):
    """Plain PyTorch version of ``warp_bilinear_segments``: each
    segment's samples by ``warp_bilinear_plain``, side by side."""
    b = planes.shape[0]
    return torch.cat([warp_bilinear_plain(planes, xs.reshape(b, -1),
                                          ys.reshape(b, -1))
                      for xs, ys, _ in segments], dim=2)


def _segment_sizes(b, xs):
    """Output pixels per frame of each segment's coordinates [B, ...]."""
    return [x.numel() // b if b else 0 for x in xs]


def _segments_cpu(planes, xs, ys, widths):
    """The segment operator's CPU implementation: its plain version."""
    return warp_bilinear_segments_plain(planes, list(zip(xs, ys, widths)))


def _segments_cuda(planes, xs, ys, widths):
    """One launch of ``csrc/warp_bilinear.cu``: the coordinates are read
    where they lie, through a table of (xs, ys, pixels, width) rows."""
    global LAUNCHES
    b, _, h, w = planes.shape
    sizes = _segment_sizes(b, xs)
    p = sum(sizes)
    _cuda_planes(planes, p)
    sb, sc, sh = planes.stride()[:3]
    if 2 * sc + (h - 1) * sh + w >= 2**31:
        raise ValueError(f"a frame's planes span {2 * sc + (h - 1) * sh + w}"
                         f" elements; the kernel's offsets are 32-bit")
    out = planes.new_empty((b, 3, p))
    if b * p == 0:
        return out
    # the contiguous coordinates stay referenced until the launch
    coords = [(x.contiguous(), y.contiguous()) for x, y in zip(xs, ys)]
    table = []
    for (x, y), width, n in zip(coords, widths, sizes):
        table += (x.data_ptr(), y.data_ptr(), n, width)
    _build.launch(_build.entry("warp_bilinear", "warp_bilinear"),
                  planes.get_device(), planes.data_ptr(), sb, sc, sh, b, h,
                  w, struct.pack(f"{len(table)}q", *table), len(xs), p,
                  out.data_ptr())
    LAUNCHES += 1
    return out


def _segments_fake(planes, xs, ys, widths):
    b = planes.shape[0]
    return planes.new_empty((b, 3, sum(_segment_sizes(b, xs))))


segments_op = _build.register(
    "warp_bilinear_segments",
    "(Tensor planes, Tensor[] xs, Tensor[] ys, int[] widths) -> Tensor",
    _segments_cpu, _segments_cuda, _segments_fake)


def _on_kernel_device(planes):
    """The wrappers take CPU tensors (the plain version) and CUDA tensors
    (the kernel); anything else raises."""
    if not (planes.is_cpu or planes.is_cuda):
        raise ValueError(f"no warp kernel for device {planes.device}")


def warp_bilinear_segments(planes, segments):
    """Samples [B, 3, P_1 + ... + P_n] of f32 planes [B, 3, H, W] at
    every segment (xs_i, ys_i, width_i) of ``segments`` (1 to
    ``MAX_SEGMENTS``): xs_i/ys_i [B, ...], the P_i pixels per frame of a
    grid (or of K faces' grids) whose rows are ``width_i`` long, in
    order; segment i's samples follow segment i - 1's.  One launch of
    ``csrc/warp_bilinear.cu`` for CUDA tensors, which reads each
    segment's coordinates where they are (no concatenation, no reshape)
    and tiles each grid in 2-D by its width; the plain version for CPU
    tensors.  Both through the operator ``segments_op``."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1 to {MAX_SEGMENTS} segments, got "
                         f"{len(segments)}")
    _check_planes(planes, (torch.float32,))
    for xs, ys, width in segments:
        _check_coords(planes, xs, ys, grid=True)
        if width < 1:
            raise ValueError(f"grid width must be >= 1, got {width}")
    _on_kernel_device(planes)
    return segments_op(planes, [xs for xs, _, _ in segments],
                       [ys for _, ys, _ in segments],
                       [int(width) for _, _, width in segments])


def warp_bilinear(planes, xs, ys):
    """Samples [B, 3, P] of f32 planes [B, 3, H, W] at xs/ys [B, P]: the
    CUDA kernel for CUDA tensors (one segment, tiled in runs of
    ``FLAT_WIDTH`` pixels), the plain version for CPU tensors."""
    return warp_bilinear_segments(planes, [(xs, ys, FLAT_WIDTH)])


def _strips_cuda(planes, xs, ys):
    """One launch of ``csrc/warp_bilinear_strips.cu`` (its bf16 or f32
    entry point, by the planes' type)."""
    global STRIP_LAUNCHES
    p = xs.shape[1]
    _cuda_planes(planes, p)
    b, _, h, w = planes.shape
    xs = xs.contiguous()
    ys = ys.contiguous()
    out = planes.new_empty((b, 3, p), dtype=torch.float32)
    if b * p == 0:
        return out
    name = ("warp_bilinear_strips_bf16" if planes.dtype == torch.bfloat16
            else "warp_bilinear_strips_f32")
    _build.launch(_build.entry("warp_bilinear_strips", name),
                  planes.get_device(), planes.data_ptr(),
                  *planes.stride()[:3], b, h, w, xs.data_ptr(),
                  ys.data_ptr(), p, out.data_ptr())
    STRIP_LAUNCHES += 1
    return out


def _strips_fake(planes, xs, ys):
    return planes.new_empty((planes.shape[0], 3, xs.shape[1]),
                            dtype=torch.float32)


strips_op = _build.register(
    "warp_bilinear_strips", "(Tensor planes, Tensor xs, Tensor ys) -> Tensor",
    warp_bilinear_strips_plain, _strips_cuda, _strips_fake)


def warp_bilinear_strips(planes, xs, ys):
    """Samples [B, 3, P] of bf16 or f32 planes [B, 3, H, W] at xs/ys
    [B, P]: the strip kernel for CUDA tensors, its plain version for CPU
    tensors (both through the operator ``strips_op``).

    Each row of xs/ys holds every grid of every face of that frame side
    by side ([B, K*P]), so the frame index of a row stands in for the
    TPU kernel's plane map g // plane_ratio: K faces share their frame's
    planes without a copy."""
    _check(planes, xs, ys, (torch.bfloat16, torch.float32))
    _on_kernel_device(planes)
    return strips_op(planes, xs, ys)


def staged_cap(itemsize: int) -> int:
    """Elements of one channel's window in each of the staged kernel's
    buffers: a third of ``STAGE_BYTES``, in whole 16-byte units (each
    window row a whole number of bulk-copy units)."""
    unit = 16 // itemsize
    return STAGE_BYTES // (3 * itemsize) // unit * unit


def warp_bilinear_strips_staged(planes, xs, ys, copies="fused",
                                stats=None):
    """Samples [B, 3, P] of bf16 or f32 planes [B, 3, H, W] at xs/ys
    [B, ..., Ho, Wo] (the grids of each frame, all of one size; P their
    pixels in order): the staged kernel for CUDA tensors,
    ``warp_bilinear_strips_plain`` for CPU tensors.  ``copies`` is
    "fused" (one copy of the three channels' window per block) or
    "split" (one per channel).  ``stats``, an int64 [2] tensor on the
    planes' device, takes the kernel's counts: it adds the bytes its
    windows' copies moved and the blocks whose window did not hold all
    their taps (the plain version stages nothing and leaves it alone)."""
    if copies not in STAGED_LAUNCHES:
        raise ValueError(f"copies must be one of {sorted(STAGED_LAUNCHES)}, "
                         f"got {copies!r}")
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,)
                              or not stats.is_contiguous()
                              or stats.device != planes.device):
        raise ValueError(f"stats must be a contiguous int64 [2] tensor on "
                         f"{planes.device}, got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")
    if xs.dim() < 3:
        raise ValueError(f"xs/ys must be [B, ..., Ho, Wo] grids, got "
                         f"{tuple(xs.shape)}")
    flat_x, flat_y = xs.flatten(1), ys.flatten(1)
    _check(planes, flat_x, flat_y, (torch.bfloat16, torch.float32))
    if xs.shape != ys.shape:
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)} "
                         f"differ")
    if planes.is_cpu:
        return warp_bilinear_strips_plain(planes, flat_x, flat_y)
    if not planes.is_cuda:
        raise ValueError(f"no warp kernel for device {planes.device}")
    b, _, h, w = planes.shape
    gh, gw = xs.shape[-2:]
    groups = math.prod(xs.shape[1:-2])
    if b > 65535 or flat_x.shape[1] >= 2**30 or max(h, w) >= 2**24:
        raise ValueError(f"warp too large: B={b} P={flat_x.shape[1]} H={h} "
                         f"W={w}")
    planes = planes.contiguous()
    if planes.data_ptr() % 16:
        raise ValueError("the staged kernel's bulk copies need the planes "
                         "16-byte aligned")
    rt, cw = STAGED_BLOCK
    tiles = -(-gh // rt)
    if groups * tiles >= 2**31:
        raise ValueError(f"too many row tiles: {groups} grids x {tiles}")
    cap = staged_cap(planes.element_size())
    xs, ys = flat_x.contiguous(), flat_y.contiguous()
    out = torch.empty((b, 3, xs.shape[1]), dtype=torch.float32,
                      device=planes.device)
    if out.numel() == 0:
        return out
    name = "bf16" if planes.dtype == torch.bfloat16 else "f32"
    _build.launch(_build.entry("warp_strips_staged",
                               f"warp_strips_staged_{copies}_{name}"),
                  planes.get_device(), planes.data_ptr(), b, h, w, xs.data_ptr(),
                  ys.data_ptr(), groups, gh, gw, rt, cw, cap, out.data_ptr(),
                  None if stats is None else stats.data_ptr())
    STAGED_LAUNCHES[copies] += 1
    return out


def warp_sample_multi(planes, coords):
    """Bilinear-sample several output grids of one frame batch in one
    launch.

    planes: [B, 3, H, W] (``make_planes``): f32 planes go to
    ``warp_bilinear_segments`` (each grid a segment, read where it lies;
    at most ``MAX_SEGMENTS`` grids), bf16 planes to
    ``warp_bilinear_strips`` (the grids concatenated).
    coords: list of (src_x, src_y) pairs, each [B, ..., Ho_i, Wo_i] (a
    face axis K after the batch axis puts every face of a frame in the
    same launch, against that frame's planes).  Grids may differ in
    size.  Returns a list of [B, ..., Ho_i, Wo_i, 3] f32 samples."""
    b = planes.shape[0]
    if planes.dtype == torch.bfloat16:
        xs = torch.cat([sx.reshape(b, -1) for sx, _ in coords], dim=1)
        ys = torch.cat([sy.reshape(b, -1) for _, sy in coords], dim=1)
        out = warp_bilinear_strips(planes, xs, ys)
    else:
        out = warp_bilinear_segments(
            planes, [(sx, sy, sx.shape[-1]) for sx, sy in coords])
    return _grid_views(out, coords)


def warp_sample_multi_plain(planes, coords):
    """``warp_sample_multi`` by the plain gather (``warp_bilinear_plain``)
    on either device: the cascade's ``warp_method="gather"``, which
    launches no kernel."""
    b = planes.shape[0]
    _check_planes(planes, (torch.bfloat16, torch.float32))
    xs = torch.cat([sx.reshape(b, -1) for sx, _ in coords], dim=1)
    ys = torch.cat([sy.reshape(b, -1) for _, sy in coords], dim=1)
    return _grid_views(warp_bilinear_plain(planes, xs, ys), coords)


def _grid_views(out, coords):
    """Each grid's samples [B, ..., Ho, Wo, 3] of the warp output ``out``
    [B, 3, P] (the grids of ``coords`` side by side)."""
    b = out.shape[0]
    # channel-last views [B, ..., Ho, Wo, 3] of each grid's part of the
    # channel-major [B, 3, P] storage, one as_strided each (with one face
    # per frame the nets read them back as NCHW without a copy)
    p = out.shape[2]
    views, off = [], out.storage_offset()
    for sx, _ in coords:
        shape = sx.shape[1:]
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        views.append(out.as_strided((b, *shape, 3), (3 * p, *strides, p),
                                    off))
        off += math.prod(shape)
    return views


def warp_sample(planes, src_x, src_y):
    """Single-grid convenience wrapper over ``warp_sample_multi``."""
    (out,) = warp_sample_multi(planes, [(src_x, src_y)])
    return out
