"""The one traffic generator: the same seed gives the same frames, any
seed the same sizes, and the frames hold what the mix says."""

import json

import pytest
import torch

from harness import frames
from helpers import HERE, SEED


def _traffic(name, **kw):
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(kw)
    return t


@pytest.mark.parametrize("name", ["batch540", "crowd720"])
def test_pool_is_deterministic_per_seed(name):
    t = _traffic(name, batch=3, pool=2)
    a = frames.make_pool(t, HERE / "traffic", SEED, "cpu")
    b = frames.make_pool(t, HERE / "traffic", SEED, "cpu")
    c = frames.make_pool(t, HERE / "traffic", SEED + 1, "cpu")
    assert len(a) == 2
    for x, y, z in zip(a, b, c):
        assert x.shape == (3, t["height"], t["width"], 3)
        assert x.dtype == torch.uint8 and x.is_contiguous()
        assert torch.equal(x, y)
        assert x.shape == z.shape and not torch.equal(x, z)
    # every frame of the pool differs from every other
    flat = torch.cat(a).flatten(1)
    assert len({bytes(f.numpy()) for f in flat}) == flat.shape[0]


def test_draws_keep_sizes_and_ranges():
    t = _traffic("crowd720")
    sizes = [(540, 360, (184.8, 80.8, 317.5, 213.6))]
    rng = __import__("numpy").random.default_rng(SEED)
    photo, cx, cy, ww, mirror, bright = frames.draw_tiles(t, 1, sizes, 4000,
                                                          rng)
    span = (317.5 - 184.8) / ww
    assert span.min() >= t["face_span"][0] and span.max() <= t["face_span"][1]
    assert bright.min() >= -25 and bright.max() <= 25
    assert 0.4 < mirror.mean() < 0.6
    t = _traffic("batch540")
    photo, cx, cy, ww, mirror, bright = frames.draw_tiles(t, 1, sizes, 4000,
                                                          rng)
    zoom = min(540, 360 * 1.5) / ww
    assert zoom.min() >= 0.8 and zoom.max() <= 1.2
    # the shift moves the content by at most a sixth of the frame
    assert abs(cx - 270).max() <= ww.max() / 6 + 1e-6


def test_tiles_fill_the_grid():
    t = _traffic("crowd720", batch=1, pool=1, mirror=0.0,
                 brightness=[0, 0])
    (canvas,) = frames.make_pool(t, HERE / "traffic", SEED, "cpu")
    # four tiles, each with content of its own
    q = [canvas[0, y:y + 360, x:x + 640] for y in (0, 360) for x in (0, 640)]
    assert all(tile.float().mean() > 20 for tile in q)
    assert len({bytes(tile.numpy()) for tile in q}) == 4
