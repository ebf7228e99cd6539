"""Image preprocessing of the cascade (counterpart of tpu_face/ops/image.py).

The reference's ``image_to_tensor`` chain (warp_perspective ->
copy_make_border -> resize -> resize -> normalize, transform.rs:188-309)
composes into ONE affine map, so every warp is one bilinear sample of
the source frame plus a fused normalize.  Letterbox padding is pure
math: the pad region maps outside the frame and reads zeros.

Functions take an optional leading batch: ROI tensors ``[..., 5]`` give
coordinate grids ``[..., Ho, Wo]``, and per-frame scalars broadcast over
the grid.  All arithmetic is f32 in the JAX package's order, so the two
packages agree to rounding.

The standalone models' entry into it is ``warp_image_to_tensor``, whose
"pallas" method is the warp kernels (``ops/warp.py``).
"""

import math
from typing import Optional, Tuple

import torch

from . import warp


def bilinear_sample(image, xs, ys):
    """Bilinear sample with constant-zero border.

    image: [..., H, W, C] float; xs/ys: [..., Ho, Wo] source pixel
    coordinates with the same leading dims.  Returns [..., Ho, Wo, C]."""
    h, w, c = image.shape[-3:]
    lead = xs.shape[:-2]
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    dx = (xs - x0f)[..., None]
    dy = (ys - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = image.reshape(*lead, h * w, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        lin = lin.reshape(*lead, -1, 1)
        vals = torch.gather(flat, -2, lin.expand(*lin.shape[:-1], c))
        return torch.where(valid[..., None], vals.reshape(*xs.shape, c),
                           0.0)

    top = tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx
    bot = tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx
    return top * (1 - dy) + bot * dy


def letterbox_padding(roi_w, roi_h, out_size: Tuple[int, int]):
    """Letterbox padding fractions + effective pixel pads
    (transform.rs:236-257): (pad_x, pad_y, ph, pv) as f32 tensors.

    Multiply-before-divide keeps integer-valued ROI dims exact in f32
    (540x360 -> 256x256 gives pv = 90, not 89.99999 -> 89)."""
    # integer-division aspect quirk kept from transform.rs:240
    out_aspect = float(out_size[1] // out_size[0])
    roi_aspect = roi_h / roi_w
    w_i = torch.trunc(roi_w)
    h_i = torch.trunc(roi_h)

    cond = out_aspect > roi_aspect
    pad_y = torch.where(cond, (1.0 - roi_aspect / out_aspect) / 2.0, 0.0)
    pad_x = torch.where(cond, 0.0, (1.0 - out_aspect / roi_aspect) / 2.0)
    new_h = torch.where(cond, torch.trunc(roi_w * out_aspect), h_i)
    new_w = torch.where(cond, w_i, torch.trunc(roi_h / out_aspect))

    changed = (new_w != w_i) | (new_h != h_i)
    pv_exact = (new_h - (new_h * roi_h) / (roi_w * out_aspect)) / 2.0
    ph_exact = (new_w - (new_w * out_aspect * roi_w) / roi_h) / 2.0
    ph = torch.where(changed & ~cond, torch.trunc(ph_exact), 0.0)
    pv = torch.where(changed & cond, torch.trunc(pv_exact), 0.0)
    return pad_x, pad_y, ph, pv


def letterbox_two_stage_params(image_size: Tuple[int, int],
                               out_size: Tuple[int, int]):
    """Whether the reference's double-resize letterbox differs from the
    fused single resample for a WHOLE-IMAGE ROI at this geometry.

    Returns None when the fused map is exact (every landscape/square
    geometry in practice), else the static intermediate geometry
    ``(new_w, new_h, ph, pv, pad_x, pad_y)`` for
    ``letterbox_two_stage`` (e.g. 200x225 portraits, whose int-truncated
    pads make the first resize non-identity).  Host-side, static ints
    only."""
    w, h = int(image_size[0]), int(image_size[1])
    out_aspect = float(out_size[1] // out_size[0])  # transform.rs:240
    roi_aspect = h / w
    if out_aspect > roi_aspect:
        new_w, new_h = w, int(w * out_aspect)
        pad_x, pad_y = 0.0, (1.0 - roi_aspect / out_aspect) / 2.0
    else:
        new_w, new_h = int(h / out_aspect), h
        pad_x, pad_y = (1.0 - out_aspect / roi_aspect) / 2.0, 0.0
    if (new_w, new_h) == (w, h):
        return None                      # no letterbox stage at all
    ph, pv = int(pad_x * new_w), int(pad_y * new_h)
    if (w + 2 * ph, h + 2 * pv) == (new_w, new_h):
        return None                      # resize1 is identity -> fused
    return (new_w, new_h, ph, pv, pad_x, pad_y)


def _axis_grid(n_new, n_src, pad, device):
    """Half-pixel resize coordinates of one axis: output pixel centres
    of an ``n_new``-wide resize of the ``n_src + 2*pad`` padded source,
    in source pixels."""
    return ((torch.arange(n_new, dtype=torch.float32, device=device) + 0.5)
            * (n_src + 2 * pad) / n_new - 0.5 - pad)


def letterbox_two_stage(source, image_size: Tuple[int, int],
                        out_size: Tuple[int, int], params,
                        output_range: Tuple[float, float],
                        planar: bool = False):
    """Exact reference double-resize letterbox for the whole-image ROI
    (transform.rs:252-280), with the intermediate uint8 quantization
    between the two resizes; both resizes are separable hat matmuls.

    ``source``: [..., H, W, 3] f32 frames, or [..., 3, H, W] channel
    planes with ``planar=True``.  Returns (tensor [..., Ho, Wo, 3] f32,
    padding (4,) f32)."""
    w, h = int(image_size[0]), int(image_size[1])
    wo, ho = out_size
    new_w, new_h, ph, pv, pad_x, pad_y = params
    dev = source.device

    # stage 1: copy_make_border + resize to (new_w, new_h); the pad
    # composes into the coordinate map (outside taps read zeros)
    x1 = _axis_grid(new_w, w, ph, dev)
    y1 = _axis_grid(new_h, h, pv, dev)
    sx = x1[None, :].expand(new_h, new_w)
    sy = y1[:, None].expand(new_h, new_w)
    if planar:
        mid = separable_sample_planar(source, sx, sy)
    else:
        mid = separable_sample(source.float(), sx, sy)
    mid = torch.round(mid)

    # stage 2: resize to out_size over the uint8-quantized intermediate
    x2 = _axis_grid(wo, new_w, 0, dev)
    y2 = _axis_grid(ho, new_h, 0, dev)
    out = separable_sample(mid, x2[None, :].expand(ho, wo),
                           y2[:, None].expand(ho, wo))
    # filled on the device: a host tensor copy would sync the stream
    padding = torch.empty(4, dtype=torch.float32, device=dev)
    padding[0::2] = pad_x
    padding[1::2] = pad_y
    return _normalize_pixels(out, output_range, True), padding


def warp_derivatives(roi_abs, out_size: Tuple[int, int],
                     keep_aspect_ratio: bool):
    """|d src / d out| magnitudes (dxdu, dxdv, dydu, dydv) of the
    ``image_to_tensor`` warp map, from the same letterbox algebra as
    ``_source_coords``."""
    rw, rh, rot = roi_abs[..., 2], roi_abs[..., 3], roi_abs[..., 4]
    wo, ho = out_size
    if keep_aspect_ratio:
        _, _, ph, pv = letterbox_padding(rw, rh, out_size)
        w_i = torch.trunc(rw)
        h_i = torch.trunc(rh)
        qx_u = (w_i + 2.0 * ph) / (wo * torch.clamp(w_i, min=1.0))
        qy_v = (h_i + 2.0 * pv) / (ho * torch.clamp(h_i, min=1.0))
    else:
        qx_u = torch.full_like(rw, 1.0 / wo)
        qy_v = torch.full_like(rh, 1.0 / ho)
    s, c = torch.sin(rot), torch.cos(rot)
    return (torch.abs(qx_u * rw * c), torch.abs(qy_v * rh * s),
            torch.abs(qx_u * rw * s), torch.abs(qy_v * rh * c))


def _source_coords(roi_abs, out_size: Tuple[int, int],
                   keep_aspect_ratio: bool, flip_horizontal):
    """Source sampling coordinates of the ``image_to_tensor`` warp.

    roi_abs: [..., 5] (cx, cy, w, h, rotation) in absolute pixels;
    flip_horizontal: bool or bool tensor [...].  Returns (src_x
    [..., Ho, Wo], src_y [..., Ho, Wo], padding [..., 4])."""
    wo, ho = out_size
    dev = roi_abs.device

    def per_frame(v):
        return v[..., None, None]

    cx, cy, rw, rh, rot = (roi_abs[..., k] for k in range(5))

    # output pixel grid (optionally mirrored)
    u = torch.arange(wo, dtype=torch.float32, device=dev)[None, :].expand(
        ho, wo)
    v = torch.arange(ho, dtype=torch.float32, device=dev)[:, None].expand(
        ho, wo)
    if isinstance(flip_horizontal, torch.Tensor):
        u = torch.where(per_frame(flip_horizontal), (wo - 1) - u, u)
    elif flip_horizontal:
        u = (wo - 1) - u

    if keep_aspect_ratio:
        # resize2^-1 . resize1^-1 . unpad: the intermediate (new_w,
        # new_h) target cancels out of the half-pixel algebra
        pad_x, pad_y, ph, pv = letterbox_padding(rw, rh, out_size)
        w_i = torch.trunc(rw)
        h_i = torch.trunc(rh)
        x0 = ((u + 0.5) * per_frame(w_i + 2.0 * ph) / wo - 0.5
              - per_frame(ph))
        y0 = ((v + 0.5) * per_frame(h_i + 2.0 * pv) / ho - 0.5
              - per_frame(pv))
        qx = x0 / per_frame(w_i)
        qy = y0 / per_frame(h_i)
        padding = torch.stack([pad_x, pad_y, pad_x, pad_y], dim=-1)
    else:
        # direct warp: warp_perspective samples dst integer coords
        qx = u / wo
        qy = v / ho
        padding = torch.zeros(roi_abs.shape[:-1] + (4,),
                              dtype=torch.float32, device=dev)

    # rotated-rect corners (types.rs:80-96); the perspective transform
    # of a parallelogram quad is exactly affine
    s, c = torch.sin(rot), torch.cos(rot)
    hw, hh = rw / 2.0, rh / 2.0
    c0x, c0y = cx + (-hw) * c - (-hh) * s, cy + (-hw) * s + (-hh) * c
    c1x, c1y = cx + hw * c - (-hh) * s, cy + hw * s + (-hh) * c
    c3x, c3y = cx + (-hw) * c - hh * s, cy + (-hw) * s + hh * c

    src_x = (per_frame(c0x) + qx * per_frame(c1x - c0x)
             + qy * per_frame(c3x - c0x))
    src_y = (per_frame(c0y) + qx * per_frame(c1y - c0y)
             + qy * per_frame(c3y - c0y))
    return src_x, src_y, padding


def _normalize_pixels(out, output_range: Tuple[float, float],
                      quantize_uint8: bool):
    if quantize_uint8:
        # the reference chain materializes uint8 Mats between stages
        # (round half to even); torch.round rounds half to even too
        out = torch.round(out)
    lo, hi = output_range
    return out * ((hi - lo) / 255.0) + lo


def _hat(t):
    """Bilinear hat weights max(0, 1 - |t|): a row over integer taps k
    at t = k - s reproduces the two-tap zero-border bilinear at s."""
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _hat_rows(coords, n):
    """[..., n_out, n] hat weights of ``coords`` [..., n_out] over the
    integer taps 0..n-1."""
    taps = torch.arange(n, dtype=torch.float32, device=coords.device)
    return _hat(taps - coords[..., None])


def separable_sample(image, src_x, src_y):
    """Bilinear sample for AXIS-ALIGNED maps (rotation 0): src_x
    constant along rows, src_y along columns.  Two hat-weight matmuls
    over the whole frame.

    image: [..., H, W, C]; src_x/src_y: [Ho, Wo] (shared) or
    [..., Ho, Wo].  Returns [..., Ho, Wo, C].  Runs in full f32: the
    caller disables TF32, or the hat weights would round and ``rint``
    flip levels."""
    h, w, c = image.shape[-3:]
    wx = _hat_rows(src_x[..., 0, :], w)            # [..., Wo, W]
    wy = _hat_rows(src_y[..., :, 0], h)            # [..., Ho, H]
    t1 = torch.matmul(wy, image.reshape(*image.shape[:-3], h, w * c))
    t1 = t1.reshape(*t1.shape[:-1], w, c)          # [..., Ho, W, C]
    return torch.matmul(wx.unsqueeze(-3), t1)      # [..., Ho, Wo, C]


# Largest f32 copy of bf16 planes that ``separable_sample_planar`` makes
# at once: frames are upcast a chunk at a time (at 1080p, batch 64, a
# whole f32 copy would be 1.59 GB; a chunk is 10 frames, 249 MB).
UPCAST_CHUNK_BYTES = 256 * 2**20


def separable_sample_planar(planes, src_x, src_y, dot_dtype=None):
    """``separable_sample`` over channel planes [B, 3, H, W]: per
    channel ``wy @ P @ wx^T``.  src_x/src_y: [Ho, Wo] (shared) or
    [B, Ho, Wo].  Returns [B, Ho, Wo, 3] f32 (a channel-last view of
    channel-major storage).

    ``dot_dtype=None``: bf16 planes are upcast to f32 before the
    products, which is exact for uint8 pixel values, so bf16 and f32
    planes give the same result; the upcast runs over chunks of frames of
    at most ``UPCAST_CHUNK_BYTES``.

    ``dot_dtype=torch.bfloat16`` (the JAX version's): the hat weights are
    rounded to bf16 and the planes read as bf16 (exact for uint8); the
    first product accumulates in f32 and is stored as bf16, the second
    takes those bf16 values and accumulates in f32 (its operands widened
    to f32, which is exact).  Only the rounded weights and the bf16
    intermediate differ from the f32 path: at most one uint8 level on
    the output."""
    h, w = planes.shape[-2:]
    wx = _hat_rows(src_x[..., 0, :], w)            # [..., Wo, W]
    wy = _hat_rows(src_y[..., :, 0], h)            # [..., Ho, H]
    if dot_dtype is not None:
        if dot_dtype != torch.bfloat16:
            raise ValueError(f"dot_dtype must be None or bfloat16, got "
                             f"{dot_dtype}")
        bf = torch.bfloat16
        t1 = torch.matmul(wy.to(bf).unsqueeze(-3), planes.to(bf))
        out = torch.matmul(t1.float(),
                           wx.to(bf).float().unsqueeze(-3).transpose(-1, -2))
        return out.movedim(-3, -1)
    if planes.dtype == torch.float32:
        return _separable_planar_f32(planes, wx, wy)
    step = max(1, UPCAST_CHUNK_BYTES // (3 * h * w * 4))
    outs = []
    for i in range(0, planes.shape[0], step):
        cx = wx if wx.dim() == 2 else wx[i:i + step]
        cy = wy if wy.dim() == 2 else wy[i:i + step]
        outs.append(_separable_planar_f32(
            planes[i:i + step].to(torch.float32), cx, cy))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _separable_planar_f32(planes, wx, wy):
    t1 = torch.matmul(wy.unsqueeze(-3), planes)    # [..., 3, Ho, W]
    out = torch.matmul(t1, wx.unsqueeze(-3).transpose(-1, -2))
    return out.movedim(-3, -1)


# Largest hat-weight tensor [grids, Ho*Wo, W] f32 that ``mxu_sample``
# makes at once: its grids are sampled a chunk at a time (one 192x192 grid
# over a 540-px-wide frame needs 80 MB, over a 1920-px-wide one 283 MB).
MXU_CHUNK_BYTES = 512 * 2**20


def mxu_sample(image, src_x, src_y, band: int = 32, row_tile: int = 8):
    """Bilinear sample as banded hat-weight matmuls (the JAX package's
    ``mxu_sample``, its "mxu" warp method):

      out[p, c] = sum_y B(y - ys[p]) * sum_x B(x - xs[p]) * img[y, x, c]

    per tile of ``row_tile`` output rows: the tile's band of ``band``
    source rows starts at floor(min ys) of the tile, clamped into the
    frame; one matmul contracts x over the full width, then the band
    contracts y.  Taps outside the band read nothing: ROIs whose tile
    spans more than ``band`` rows (extreme rotation and scale) clamp to the
    band's edge, exactly as in JAX.  All tiles of all grids run batched,
    in chunks of at most ``MXU_CHUNK_BYTES`` of hat weights.  Plain torch
    ops, in full f32 (the caller disables TF32, or the hat weights would
    round and ``rint`` flip levels).

    image: [..., H, W, C] float; src_x/src_y: [..., Ho, Wo] whose leading
    dims start with the image's (e.g. frames [B, H, W, C] and grids
    [B, K, Ho, Wo]: K grids per frame).  Returns [..., Ho, Wo, C]."""
    h, w, c = image.shape[-3:]
    ho, wo = src_x.shape[-2:]
    if ho % row_tile:
        raise ValueError(f"{ho} output rows do not tile by {row_tile}")
    frames = image.shape[:-3]
    lead = src_x.shape[:-2]
    if tuple(lead[:len(frames)]) != tuple(frames):
        raise ValueError(f"grids {tuple(lead)} do not start with the "
                         f"frames' dims {tuple(frames)}")
    tiles, p = ho // row_tile, row_tile * wo
    bh = min(band, h)
    imgs = image.reshape(-1, h, w, c)
    per_frame = math.prod(lead[len(frames):])
    xs = src_x.reshape(-1, tiles, p)
    ys = src_y.reshape(-1, tiles, p)
    dev = image.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(band, dtype=torch.float32, device=dev)
    step = max(1, MXU_CHUNK_BYTES // (ho * wo * w * 4))
    outs = []
    for g0 in range(0, xs.shape[0], step):
        xs_c, ys_c = xs[g0:g0 + step], ys[g0:g0 + step]
        n = xs_c.shape[0]
        frame = torch.arange(g0, g0 + n, device=dev) // per_frame
        # per-tile band start: floor(min ys), clamped into the frame
        start = torch.floor(ys_c.amin(-1)).long().clamp(0, max(h - band, 0))
        strip = imgs[frame[:, None, None],
                     start[..., None] + torch.arange(bh, device=dev)]
        # [n, T, bh, W, C] -> [n, T, W, bh*C]: x contracts on the matmul
        strip = strip.permute(0, 1, 3, 2, 4).reshape(n, tiles, w, bh * c)
        wx = _hat(cols - xs_c[..., None])                   # [n, T, P, W]
        t1 = torch.matmul(wx, strip).reshape(n, tiles, p, bh, c)
        ys_band = ys_c - start[..., None].float()           # [n, T, P]
        wy = _hat(rows - ys_band[..., None])[..., :bh]
        outs.append(torch.einsum("ntpb,ntpbc->ntpc", wy, t1))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(*lead, ho, wo, c)


def auto_band(src_extent: int, out_h: int, minimum: int = 48) -> int:
    """``mxu_sample``'s band for the standalone models (the JAX
    package's rule): 8 output rows of the whole-image warp span
    8 * ``src_extent`` / ``out_h`` source rows (``src_extent`` the
    frame's long side), plus 24 rows for the taps and modest rotation,
    rounded up to a multiple of 8."""
    need = int(8 * src_extent / out_h) + 24
    return max(minimum, -(-need // 8) * 8)


# Sampling methods of ``warp_image_to_tensor``.
WARP_METHODS = ("gather", "pallas", "mxu", "separable")


def _check_method(method):
    if method not in WARP_METHODS:
        raise ValueError(f"warp method {method!r}, expected one of "
                         f"{WARP_METHODS}")


def warp_image_to_tensor(image, roi_abs, out_size: Tuple[int, int],
                         keep_aspect_ratio: bool,
                         output_range: Tuple[float, float] = (0.0, 1.0),
                         flip_horizontal=False,
                         quantize_uint8: bool = True,
                         method: str = "gather", band: int = 32):
    """The fused ``image_to_tensor``: one resampling pass + one fma.

    image: [H, W, 3] or a batch [B, H, W, 3] (uint8 or float, RGB);
    roi_abs: (5,) or [B, 5] (cx, cy, w, h, rotation) in absolute pixels;
    flip_horizontal: bool, or a bool tensor () / [B] (per frame).
    method:
      "gather"    the plain zero-border gather (``bilinear_sample``);
      "pallas"    the warp kernels, as the JAX package's Pallas path:
                  f32 planes (``warp.make_planes``), K1
                  (``warp.warp_bilinear``) where ``warp.planes_fit_vmem``
                  holds, else K2 (``warp.warp_bilinear_strips``) over the
                  same f32 planes; on a CPU tensor their plain versions;
      "mxu"       the banded hat-weight matmuls (``mxu_sample``) with
                  ``band`` source rows per 8 output rows, plain torch
                  ops on either device;
      "separable" two hat matmuls, for rotation-free ROIs.

    Returns (tensor [(B,) Ho, Wo, 3] f32, padding [(B,) 4] f32)."""
    _check_method(method)
    batched = image.dim() == 4
    images = image if batched else image[None]
    rois = roi_abs if batched else roi_abs[None]
    if isinstance(flip_horizontal, torch.Tensor):
        flip_horizontal = flip_horizontal.reshape(rois.shape[:-1])
    src_x, src_y, padding = _source_coords(rois, out_size,
                                           keep_aspect_ratio,
                                           flip_horizontal)
    if method == "pallas":
        b, h, w = images.shape[:3]
        planes = warp.make_planes(images)
        kernel = (warp.warp_bilinear if warp.planes_fit_vmem(h, w)
                  else warp.warp_bilinear_strips)
        out = kernel(planes, src_x.reshape(b, -1), src_y.reshape(b, -1))
        out = out.reshape(b, 3, *src_x.shape[1:]).movedim(1, -1)
    elif method == "mxu":
        out = mxu_sample(images.float(), src_x, src_y, band=band)
    elif method == "separable":
        out = separable_sample(images.float(), src_x, src_y)
    else:
        out = bilinear_sample(images.float(), src_x, src_y)
    out = _normalize_pixels(out, output_range, quantize_uint8)
    if not batched:
        out, padding = out[0], padding[0]
    return out, padding


def resolve_warp_method(method: str = "auto", device=None) -> str:
    """Map "auto" to the device's fast exact path: the warp kernels
    ("pallas", the JAX package's name for its kernel path) on the card,
    the plain gather on the CPU.  ``device=None`` means the card."""
    if method == "auto":
        dev = torch.device("cuda" if device is None else device)
        return "pallas" if dev.type == "cuda" else "gather"
    _check_method(method)
    return method


def choose_warp_method(method: str, roi_abs_rows, image_size,
                       out_size, keep_aspect_ratio: bool,
                       plane_dtype=None):
    """Per-call warp dispatch of the standalone models' host APIs.

    The JAX version sizes its TPU kernel's block geometry and static
    sampling window to the call's concrete ROIs and falls back to the
    exact gather beyond them.  The card's warp kernels have no window and
    sample every ROI exactly, so there is nothing to size: the method
    comes back as it is (validated).  The other arguments are kept for
    signature parity."""
    _check_method(method)
    return method


def whole_image_roi(image_size: Tuple[int, int], device=None):
    """Default ROI covering the full image, in absolute coordinates
    (reference transform.rs:190-199), on ``device`` (None: the card)."""
    from .. import resolve_device
    w, h = image_size
    return torch.tensor([0.5 * w, 0.5 * h, float(w), float(h), 0.0],
                        dtype=torch.float32, device=resolve_device(device))


def image_to_tensor(image, roi=None, output_size: Optional[Tuple[int, int]]
                    = None, keep_aspect_ratio: bool = False,
                    output_range: Tuple[float, float] = (0.0, 1.0),
                    flip_horizontal: bool = False, device=None):
    """Host-facing ``image_to_tensor`` with the reference signature
    (reference transform.rs:188-309): RGB image + optional normalized
    ``Rect`` ROI -> ``ImageTensor`` (tensor, letterbox padding, original
    size), computed on ``device`` (None: the card) with the plain
    gather, as the JAX version's default method."""
    import numpy as np

    from .. import exact_f32, resolve_device
    from ..types import ImageTensor, Rect
    from ..utils.image_io import load_image

    dev = resolve_device(device)
    img = load_image(image)
    h, w = img.shape[:2]
    whole = roi is None
    if roi is None:
        roi = Rect(0.5, 0.5, 1.0, 1.0, 0.0, normalized=True)
    r = roi.scaled((float(w), float(h)), normalize=False)
    if output_size is None:
        output_size = (int(r.width), int(r.height))
    two = (letterbox_two_stage_params((w, h), output_size)
           if (whole and keep_aspect_ratio) else None)
    frame = torch.from_numpy(np.require(img, requirements="CW")).to(dev)
    with torch.inference_mode(), exact_f32():
        if two is not None:
            tensor, padding = letterbox_two_stage(
                frame.float(), (w, h), output_size, two, output_range)
            if flip_horizontal:
                tensor = tensor.flip(1)  # reference flips the final Mat
        else:
            roi_abs = torch.tensor(
                [r.x_center, r.y_center, r.width, r.height, r.rotation],
                dtype=torch.float32, device=dev)
            tensor, padding = warp_image_to_tensor(
                frame, roi_abs, output_size, keep_aspect_ratio,
                output_range, flip_horizontal)
    pad = padding.cpu().numpy().astype(np.float64)
    return ImageTensor(tensor.cpu().numpy(),
                       (pad[0], pad[1], pad[2], pad[3]), (w, h))
