"""The cascade's rotated-ROI warp: bilinear sampling of several
coordinate grids from one frame's channel planes in one kernel launch.

Counterpart of tpu_face/ops/pallas_warp.py.  On a CUDA tensor
``warp_sample_multi`` launches the hand-written kernel
``csrc/warp_bilinear.cu`` (which replaces the Pallas ``_warp_kernel``);
on a CPU tensor it runs ``warp_bilinear_plain``, the same function in
plain PyTorch.  The kernel has no static sampling window, so unlike the
TPU kernel it needs no envelope check: every ROI is sampled exactly.

``LAUNCHES`` counts kernel launches (the plain path never adds to it),
so a run can show that the main path went through the kernel.
"""

import torch

from . import _build

LAUNCHES = 0


def make_planes(images, layout: str = "hwc"):
    """[B, 3, H, W] contiguous f32 channel planes of a frame batch
    ([B, H, W, 3] for ``layout="hwc"``, [B, 3, H, W] for "planar"),
    built once per batch and shared by every warp of it.  Unlike the
    TPU kernel's planes they are not padded."""
    if layout == "hwc":
        images = images.permute(0, 3, 1, 2)
    elif layout != "planar":
        raise ValueError(f"layout {layout!r}")
    return images.to(torch.float32).contiguous()


def warp_bilinear_plain(planes, xs, ys):
    """Plain PyTorch version of the kernel: zero-border bilinear samples
    (tpu_face/ops/image.py::bilinear_sample) of planes [B, 3, H, W] at
    xs/ys [B, P].  Returns [B, 3, P] f32, channel-major like the
    kernel."""
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
        return torch.where(valid[:, None], vals, 0.0)

    top = tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx
    bot = tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx
    return top * (1 - dy) + bot * dy


def _check(planes, xs, ys):
    if planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"planes must be [B, 3, H, W], got "
                         f"{tuple(planes.shape)}")
    if xs.dim() != 2 or xs.shape != ys.shape or xs.shape[0] != \
            planes.shape[0]:
        raise ValueError(f"xs/ys must be [B, P] with B = "
                         f"{planes.shape[0]}, got {tuple(xs.shape)} and "
                         f"{tuple(ys.shape)}")
    for name, t in (("planes", planes), ("xs", xs), ("ys", ys)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, planes on "
                             f"{planes.device}")


def warp_bilinear(planes, xs, ys):
    """Samples [B, 3, P] of planes [B, 3, H, W] at xs/ys [B, P]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    _check(planes, xs, ys)
    if planes.device.type == "cpu":
        return warp_bilinear_plain(planes, xs, ys)
    if planes.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {planes.device}")
    if planes.stride(3) != 1:
        raise ValueError("planes need unit stride along W")
    b, _, h, w = planes.shape
    p = xs.shape[1]
    if b > 65535 or p >= 2**30 or max(h, w) >= 2**24:
        raise ValueError(f"warp too large: B={b} P={p} H={h} W={w}")
    xs = xs.contiguous()
    ys = ys.contiguous()
    out = torch.empty((b, 3, p), dtype=torch.float32, device=planes.device)
    if b * p == 0:
        return out
    fn = _build.load("warp_bilinear").warp_bilinear
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(planes.data_ptr(), planes.stride(0), planes.stride(1),
                 planes.stride(2), b, h, w, xs.data_ptr(), ys.data_ptr(), p,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"warp_bilinear launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def warp_sample_multi(planes, coords):
    """Bilinear-sample several output grids of one frame batch in one
    launch.

    planes: [B, 3, H, W] f32 (``make_planes``); coords: list of
    (src_x, src_y) pairs, each [B, Ho_i, Wo_i].  Grids may differ in
    size.  Returns a list of [B, Ho_i, Wo_i, 3] f32 samples."""
    b = planes.shape[0]
    xs = torch.cat([sx.reshape(b, -1) for sx, _ in coords], dim=1)
    ys = torch.cat([sy.reshape(b, -1) for _, sy in coords], dim=1)
    out = warp_bilinear(planes, xs, ys)
    sizes = [sx.shape[-2] * sx.shape[-1] for sx, _ in coords]
    # channel-last views of channel-major storage: the nets read them
    # back as NCHW without a copy
    return [seg.reshape(b, 3, *sx.shape[-2:]).permute(0, 2, 3, 1)
            for seg, (sx, _) in zip(out.split(sizes, dim=2), coords)]


def warp_sample(planes, src_x, src_y):
    """Single-grid convenience wrapper over ``warp_sample_multi``."""
    (out,) = warp_sample_multi(planes, [(src_x, src_y)])
    return out
