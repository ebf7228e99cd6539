"""The staged strip warp (``ops/warp.warp_bilinear_strips_staged``, the
port of K5 and of K2's staged copy) on the CPU.

The CUDA kernel ``csrc/warp_strips_staged.cu`` cannot run here (no card,
no nvcc); chip_smoke.py holds both of its variants against the plain
version and the gather kernel on the card.  Here, for both ``copies``
values and bf16 and f32 planes:

* the wrapper's CPU path equals ``warp_bilinear_strips_plain`` on the
  grids' pixels in order, and ``tpu_face.ops.image.bilinear_sample``
  within 1e-3 (0-255 units), on ROIs past the frame edge, mirrored grids
  and several grids and faces per frame;
* the argument checks (an unknown ``copies``, flat coordinates, mismatched
  grids, bad planes, a bad ``stats`` buffer) raise, the launch counters
  never move on the CPU, and the CPU path leaves ``stats`` alone (the
  plain version stages no window; on the card the kernel counts);
* the block geometry keeps a block's window within the budget at the
  cascade's downsampling, and the two buffers fit shared memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.ops import image as jimage
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp

PIX_TOL = 1e-3
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _grids(rng, b, faces, w, h, out, flips):
    """[B, len(flips), faces, out, out] grids of random ROIs (rotation to
    +-45 deg, centres past the edge), one per flip setting."""
    xs, ys = [], []
    for flip in flips:
        n = (b, faces)
        side = rng.uniform(0.1, 0.9, n) * min(w, h)
        rois = torch.from_numpy(np.stack(
            [rng.uniform(-0.1 * w, 1.1 * w, n),
             rng.uniform(-0.1 * h, 1.1 * h, n), side,
             side * rng.uniform(0.8, 1.25, n),
             rng.uniform(-np.pi / 4, np.pi / 4, n)], -1).astype(np.float32))
        x, y, _ = timage._source_coords(rois, (out, out), True, flip)
        xs.append(x)
        ys.append(y)
    return torch.stack(xs, 1), torch.stack(ys, 1)


CASES = {"mesh": (1, 48, (False,)), "iris_pairs": (2, 16, (False, True))}


@pytest.mark.parametrize("copies", ["fused", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_path_is_the_plain_version(case, dtype, copies):
    faces, out, flips = CASES[case]
    w, h = 90, 70
    rng = np.random.default_rng(len(case) + out)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    planes = warp.make_planes(torch.from_numpy(frames), dtype=DTYPES[dtype])
    gx, gy = _grids(rng, 2, faces, w, h, out, flips)
    before = (dict(warp.STAGED_LAUNCHES), warp.LAUNCHES,
              warp.STRIP_LAUNCHES)
    got = warp.warp_bilinear_strips_staged(planes, gx, gy, copies)
    assert (dict(warp.STAGED_LAUNCHES), warp.LAUNCHES,
            warp.STRIP_LAUNCHES) == before
    xs, ys = gx.reshape(2, -1), gy.reshape(2, -1)
    assert tuple(got.shape) == (2, 3, xs.shape[1])
    assert torch.equal(got, warp.warp_bilinear_strips_plain(planes, xs, ys))
    for i in range(2):
        want = jimage.bilinear_sample(jnp.asarray(frames[i], jnp.float32),
                                      jnp.asarray(xs[i:i + 1].numpy()),
                                      jnp.asarray(ys[i:i + 1].numpy()))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want)[0].T,
                                   rtol=0, atol=PIX_TOL)


def test_default_copy_is_fused():
    planes = torch.zeros(1, 3, 8, 8, dtype=torch.bfloat16)
    x = torch.rand(1, 4, 4) * 8
    torch.testing.assert_close(
        warp.warp_bilinear_strips_staged(planes, x, x),
        warp.warp_bilinear_strips_staged(planes, x, x, copies="fused"),
        rtol=0, atol=0)


@pytest.mark.parametrize("copies", ["fused", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cpu_path_leaves_stats_alone(dtype, copies):
    rng = np.random.default_rng(11)
    planes = warp.make_planes(torch.from_numpy(rng.integers(
        0, 256, (2, 40, 50, 3), dtype=np.uint8)), dtype=DTYPES[dtype])
    gx, gy = _grids(rng, 2, 1, 50, 40, 16, (False,))
    stats = torch.tensor([5, 7])
    got = warp.warp_bilinear_strips_staged(planes, gx, gy, copies,
                                           stats=stats)
    assert stats.tolist() == [5, 7]
    assert torch.equal(got, warp.warp_bilinear_strips_staged(planes, gx, gy,
                                                             copies))


def _bad(name):
    planes = torch.zeros(2, 3, 8, 8, dtype=torch.bfloat16)
    grid = torch.zeros(2, 4, 4)
    stats = torch.zeros(2, dtype=torch.int64)
    if name.startswith("stats_"):
        return (planes, grid, grid, "fused"), {"stats": {
            "stats_int32": stats.int(),
            "stats_three": torch.zeros(3, dtype=torch.int64),
            "stats_2d": stats[None],
            "stats_strided": torch.zeros(4, dtype=torch.int64)[::2],
            "stats_meta": stats.to("meta"),
        }[name]}
    return {
        "copies": (planes, grid, grid, "dma"),
        "flat_coords": (planes, grid.reshape(2, -1), grid.reshape(2, -1),
                        "fused"),
        "grids_differ": (planes, grid, grid.reshape(2, 2, 8), "split"),
        "batch": (planes, grid[:1], grid[:1], "fused"),
        "f16_planes": (planes.half(), grid, grid, "fused"),
        "f64_coords": (planes, grid.double(), grid.double(), "split"),
        "two_channels": (planes[:, :2], grid, grid, "fused"),
        "meta_device": (planes.to("meta"), grid.to("meta"),
                        grid.to("meta"), "fused"),
    }[name], {}


@pytest.mark.parametrize("name", ["copies", "flat_coords", "grids_differ",
                                  "batch", "f16_planes", "f64_coords",
                                  "two_channels", "meta_device",
                                  "stats_int32", "stats_three", "stats_2d",
                                  "stats_strided", "stats_meta"])
def test_bad_arguments_raise(name):
    args, kwargs = _bad(name)
    with pytest.raises((ValueError, TypeError)):
        warp.warp_bilinear_strips_staged(*args, **kwargs)


@pytest.mark.parametrize("size", [(1920, 1080), (2560, 1440), (2561, 1440),
                                  (3840, 2160), (1080, 2700)])
def test_block_geometry_keeps_windows_within_budget(size):
    """One block geometry at every frame tier (replacing the JAX
    cascade's per-tier strip configuration, which sized a TPU strip):
    rt x cw threads, whole warps within the card's limit, and at up to
    2.5x downsampling of a 192-px mesh grid, rotated by up to 0.3 rad,
    the block's window over bf16 planes (the cascade's beyond ~720p) fits
    one buffer."""
    rt, cw = warp.STAGED_BLOCK
    assert (rt * cw) % 32 == 0 and rt * cw <= 1024
    assert 192 % rt == 0 and 192 % cw == 0
    w, h = size
    s = min(2.5 * 192, min(w, h)) / 192     # source px per output px
    rot = 0.3
    span_x = s * (cw * np.cos(rot) + rt * np.sin(rot)) + 2
    span_y = s * (rt * np.cos(rot) + cw * np.sin(rot)) + 2
    unit = 8
    pitch = (int(span_x) + 1 + 2 * (unit - 1)) // unit * unit
    assert pitch * (int(span_y) + 1) <= warp.staged_cap(2), size


def test_stage_budget_fits_two_buffers():
    """A window row is whole 16-byte bulk-copy units for bf16 and f32
    planes, three channels' windows fit STAGE_BYTES, and the kernel's
    shared memory (two buffers of ``staged_cap`` elements per channel,
    plus its static window records and mbarriers, 88 bytes) fits an H100
    SM (228 KiB, 1 KiB reserved per CTA) several times over."""
    for itemsize in (2, 4):
        cap = warp.staged_cap(itemsize)
        assert (cap * itemsize) % 16 == 0
        assert 3 * cap * itemsize <= warp.STAGE_BYTES
        cta = 2 * 3 * cap * itemsize + 88 + 1024
        assert 8 * cta <= 228 * 1024
