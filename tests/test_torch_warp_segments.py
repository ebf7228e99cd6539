"""The segment table of tpu_face_torch.ops.warp on the CPU.

``warp_bilinear_segments`` samples every grid of a call in one launch of
csrc/warp_bilinear.cu, each grid a segment read where it lies (no
concatenated coordinates).  The kernel cannot run here (no card, no
nvcc); chip_smoke.py holds it bit for bit against the plain version on
the card.  Here the plain path, for one, two and three grids of
different sizes and K = 1, 2 faces per frame:

* equals the plain version on the concatenated coordinates bit for bit;
* matches the JAX package's Pallas ``warp_sample_multi`` (interpret
  mode, f32 dots, ROIs inside its envelope, as tests/test_torch_warp.py
  runs it) within ``PIX_TOL`` 1e-3 in 0-255 units;
* counts no launch; the one-segment ``warp_bilinear`` is unchanged, and
  ``warp_sample_multi``'s per-grid views are those of the flat output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.ops import pallas_warp
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp

PIX_TOL = 1e-3
W, H = 160, 120
# (Ho, Wo) of the three grids, all of different sizes; the Pallas kernel
# tiles each in rt x cw = 8 x 32 blocks
SIZES = ((32, 32), (16, 32), (8, 64))
BAND, CW, RT = 48, 32, 8


def _rois(rng, n, max_rot, scale):
    side = rng.uniform(*scale, n) * min(W, H)
    return torch.from_numpy(np.stack(
        [rng.uniform(0.3 * W, 0.7 * W, n), rng.uniform(0.3 * H, 0.7 * H, n),
         side, side * rng.uniform(0.8, 1.25, n),
         rng.uniform(-max_rot, max_rot, n)], -1).astype(np.float32))


def _grids(rng, b, faces, max_rot=0.4, scale=(0.1, 0.3)):
    """Three grids [b, faces, Ho, Wo] of ``SIZES``, the second mirrored."""
    out = []
    for i, (ho, wo) in enumerate(SIZES):
        x, y, _ = timage._source_coords(
            _rois(rng, b * faces, max_rot, scale), (wo, ho), False, i == 1)
        out.append((x.reshape(b, faces, ho, wo), y.reshape(b, faces, ho, wo)))
    return out


def _segments(coords):
    return [(x, y, x.shape[-1]) for x, y in coords]


def _flat(coords):
    b = coords[0][0].shape[0]
    return (torch.cat([x.reshape(b, -1) for x, _ in coords], 1),
            torch.cat([y.reshape(b, -1) for _, y in coords], 1))


@pytest.fixture(scope="module")
def case():
    """Two 160x120 frames, their f32 planes, K = 2 faces' three grids
    inside the Pallas envelope, and the Pallas kernel's samples of each
    frame's faces' grids ([frame][face][grid] arrays [Ho, Wo, 3])."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    for _ in range(200):
        coords = _grids(rng, 2, 2)
        if all(bool(pallas_warp.envelope_ok(jnp.asarray(x[i, k].numpy()),
                                            jnp.asarray(y[i, k].numpy()),
                                            CW, BAND))
               for x, y in coords for i in range(2) for k in range(2)):
            break
    else:
        pytest.fail("no ROI set inside the Pallas envelope")
    # one Pallas call per grid: a call's grids share their width
    want = [[[np.asarray(pallas_warp.warp_sample_multi(
        jnp.asarray(frames[i], jnp.float32),
        [(jnp.asarray(x[i, k].numpy()), jnp.asarray(y[i, k].numpy()))],
        band=BAND, dot_dtype=None, interpret=True, cw=CW, rt=RT)[0])
        for x, y in coords] for k in range(2)] for i in range(2)]
    return warp.make_planes(torch.from_numpy(frames)), coords, want


CASES = [(n, k) for n in (1, 2, 3) for k in (1, 2)]


def _pick(coords, n, k):
    """The first ``n`` grids of ``k`` faces per frame."""
    return [(x[:, :k].contiguous(), y[:, :k].contiguous())
            for x, y in coords[:n]]


@pytest.mark.parametrize("n,k", CASES)
def test_segments_equal_the_concatenated_call(case, n, k):
    planes, coords, _ = case
    coords = _pick(coords, n, k)
    before = warp.LAUNCHES
    got = warp.warp_bilinear_segments(planes, _segments(coords))
    assert warp.LAUNCHES == before                   # CPU: the plain path
    want = warp.warp_bilinear_plain(planes, *_flat(coords))
    assert got.shape == (2, 3, sum(x[0].numel() for x, _ in coords))
    assert torch.equal(got, want)
    assert torch.equal(warp.warp_bilinear_segments_plain(
        planes, _segments(coords)), want)


@pytest.mark.parametrize("n,k", CASES)
def test_segments_match_pallas_warp_sample_multi(case, n, k):
    planes, coords, want = case
    coords = _pick(coords, n, k)
    outs = warp.warp_sample_multi(planes, coords)
    for g, ((x, _), out) in enumerate(zip(coords, outs)):
        assert tuple(out.shape) == tuple(x.shape) + (3,)
        for i in range(2):
            for f in range(k):
                np.testing.assert_allclose(out[i, f].numpy(), want[i][f][g],
                                           rtol=0, atol=PIX_TOL)


@pytest.mark.parametrize("n,k", CASES)
def test_sample_multi_views_are_the_flat_output(case, n, k):
    """Each grid's [B, K, Ho, Wo, 3] result is a view of the flat
    channel-major samples; with one face per frame each channel's [Ho,
    Wo] plane of a frame is contiguous, as the nets read it."""
    planes, coords, _ = case
    coords = _pick(coords, n, k)
    flat = warp.warp_bilinear_plain(planes, *_flat(coords))
    outs = warp.warp_sample_multi(planes, coords)
    off = 0
    for (x, _), out in zip(coords, outs):
        size = x[0].numel()
        want = flat[:, :, off:off + size].reshape(2, 3, *x.shape[1:])
        assert torch.equal(out, want.movedim(1, -1))
        if k == 1:
            assert all(out[i, 0, ..., c].is_contiguous()
                       for i in range(2) for c in range(3))
        off += size
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_one_segment_call_is_unchanged(case, layout):
    planes, coords, _ = case
    xs, ys = (t[:, :4095].contiguous() for t in _flat(coords))
    want = warp.warp_bilinear_plain(planes, xs, ys)
    before = warp.LAUNCHES
    assert torch.equal(warp.warp_bilinear(planes, xs, ys), want)
    if layout == "grid":          # a 91 x 45 grid
        got = warp.warp_bilinear_segments(
            planes, [(xs.reshape(2, 91, 45), ys.reshape(2, 91, 45), 45)])
        assert torch.equal(got, want)
    assert warp.LAUNCHES == before


def test_non_contiguous_grids_take_their_values(case):
    planes, coords, _ = case
    cut = [(x[..., :5, :7], y[..., :5, :7]) for x, y in coords]
    assert not cut[0][0].is_contiguous()
    got = warp.warp_bilinear_segments(planes, _segments(cut))
    assert torch.equal(got, warp.warp_bilinear_plain(planes, *_flat(cut)))


@pytest.mark.parametrize("bad", ["none", "five", "width", "batch", "shape",
                                 "rank", "dtype", "planes"])
def test_segments_reject_bad_inputs(bad):
    planes = torch.zeros(2, 3, 8, 8)
    xs = torch.zeros(2, 4, 4)
    seg = (xs, xs, 4)
    args = {
        "none": (planes, []),
        "five": (planes, [seg] * (warp.MAX_SEGMENTS + 1)),
        "width": (planes, [(xs, xs, 0)]),
        "batch": (planes, [(xs[:1], xs[:1], 4)]),
        "shape": (planes, [(xs, xs[:, :2], 4)]),
        "rank": (planes, [(xs[:, 0, 0], xs[:, 0, 0], 1)]),
        "dtype": (planes, [(xs.double(), xs.double(), 4)]),
        "planes": (planes.to(torch.bfloat16), [seg]),
    }[bad]
    with pytest.raises((ValueError, TypeError)):
        warp.warp_bilinear_segments(*args)


def test_sample_multi_takes_at_most_max_segments_f32_grids():
    """Over f32 planes every grid is a segment, so more than
    ``MAX_SEGMENTS`` grids raise (nothing falls back to concatenating
    them); over bf16 planes the grids are concatenated for the strip
    kernel, any number of them."""
    planes = torch.zeros(2, 3, 8, 8)
    xs = torch.zeros(2, 4, 4)
    grids = [(xs, xs)] * (warp.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError):
        warp.warp_sample_multi(planes, grids)
    outs = warp.warp_sample_multi(planes.to(torch.bfloat16), grids)
    assert [tuple(o.shape) for o in outs] == [(2, 4, 4, 3)] * len(grids)
