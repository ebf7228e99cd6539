"""The one traffic generator: a pool of distinct frame batches, made from
the seed on the device, from the parameters of a traffic file.

A canvas of ``width`` x ``height`` is a ``grid`` [rows, cols] of tiles.
Each tile is a window of one portrait (``photos``: a folder beside the
traffic file, with ``faces.json`` giving each portrait's face box),
resampled bilinearly to the tile (zeros outside the portrait), mirrored
with probability ``mirror`` and brightened by a whole number drawn from
``brightness``.  The window has the tile's aspect and lies either

* ``"anchor": "photo"``: the largest centred crop of the portrait,
  zoomed by a factor drawn from ``scale``, or
* ``"anchor": "face"``: around the face, so wide that the face spans a
  share of the tile drawn from ``face_span``,

and then moves the content by a share of the tile drawn from ``shift``
on each axis.  The draws come from ``numpy.random.default_rng(seed)`` in
one fixed order, so every seed gives the same sizes and the same seed
the same frames.  The result is ``pool`` batches of ``batch`` uint8
frames [B, H, W, 3] on the device.
"""

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# tiles resampled per call of grid_sample
CHUNK = 32


def load_photos(folder, device):
    """[(name, [3, H, W] f32 pixels on ``device``, face box)] of the
    portraits in ``folder``, in the order of its ``faces.json``."""
    from PIL import Image

    folder = Path(folder)
    faces = json.loads((folder / "faces.json").read_text())["faces"]
    out = []
    for name, box in faces.items():
        with Image.open(folder / name) as im:
            pixels = np.array(im.convert("RGB"), np.uint8)
        out.append((name, torch.from_numpy(pixels).to(device).permute(
            2, 0, 1).float(), tuple(float(v) for v in box)))
    return out


def draw_tiles(traffic, n_photos, sizes, n_tiles, rng):
    """The parameters of ``n_tiles`` tiles: (photo index, window centre x,
    y and width in the portrait's pixels, mirror, brightness) each, as
    arrays.  ``sizes`` [(w, h, face box)] of the portraits."""
    rows, cols = traffic["grid"]
    tw, th = traffic["width"] / cols, traffic["height"] / rows
    aspect = tw / th
    photo = rng.integers(0, n_photos, n_tiles)
    mirror = rng.random(n_tiles) < traffic["mirror"]
    lo, hi = traffic["brightness"]
    bright = rng.integers(lo, hi + 1, n_tiles)
    shift = rng.uniform(*traffic["shift"], size=(n_tiles, 2))
    if traffic["anchor"] == "photo":
        zoom = rng.uniform(*traffic["scale"], size=n_tiles)
    elif traffic["anchor"] == "face":
        span = rng.uniform(*traffic["face_span"], size=n_tiles)
    else:
        raise ValueError(f"anchor {traffic['anchor']!r}")
    cx, cy, ww = (np.empty(n_tiles) for _ in range(3))
    for i in range(n_tiles):
        pw, ph, (x0, y0, x1, y1) = sizes[photo[i]]
        if traffic["anchor"] == "photo":
            ww[i] = min(pw, ph * aspect) / zoom[i]
            cx[i], cy[i] = pw / 2.0, ph / 2.0
        else:
            ww[i] = (x1 - x0) / span[i]
            cx[i], cy[i] = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        # the content moves by shift * tile: the window the other way
        cx[i] -= shift[i, 0] * ww[i]
        cy[i] -= shift[i, 1] * ww[i] / aspect
    return photo, cx, cy, ww, mirror, bright


def make_pool(traffic, folder, seed, device):
    """``traffic["pool"]`` batches [batch, H, W, 3] uint8 on ``device``."""
    rows, cols = traffic["grid"]
    width, height = traffic["width"], traffic["height"]
    th, tw = height // rows, width // cols
    if (th * rows, tw * cols) != (height, width):
        raise ValueError("the grid must divide the canvas")
    frames = traffic["pool"] * traffic["batch"]
    photos = load_photos(Path(folder) / traffic["photos"], device)
    sizes = [(p.shape[2], p.shape[1], box) for _, p, box in photos]
    rng = np.random.default_rng(seed)
    photo, cx, cy, ww, mirror, bright = draw_tiles(
        traffic, len(photos), sizes, frames * rows * cols, rng)
    tiles = torch.empty((frames * rows * cols, th, tw, 3), dtype=torch.uint8,
                        device=device)
    for p, (_, pixels, _) in enumerate(photos):
        idx = np.flatnonzero(photo == p)
        pw, ph = sizes[p][0], sizes[p][1]
        for s in range(0, len(idx), CHUNK):
            part = idx[s:s + CHUNK]
            w_ = ww[part]
            theta = np.zeros((len(part), 2, 3))
            theta[:, 0, 0] = np.where(mirror[part], -1.0, 1.0) * w_ / pw
            theta[:, 0, 2] = 2.0 * cx[part] / pw - 1.0
            theta[:, 1, 1] = w_ * th / tw / ph
            theta[:, 1, 2] = 2.0 * cy[part] / ph - 1.0
            theta = torch.from_numpy(theta).float().to(device)
            grid = F.affine_grid(theta, (len(part), 3, th, tw),
                                 align_corners=False)
            out = F.grid_sample(pixels[None].expand(len(part), -1, -1, -1),
                                grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)
            out = out + torch.from_numpy(bright[part]).float().to(
                device)[:, None, None, None]
            tiles[torch.from_numpy(part).to(device)] = torch.round(
                out.clamp(0.0, 255.0)).to(torch.uint8).permute(0, 2, 3, 1)
    canvas = tiles.reshape(frames, rows, cols, th, tw, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(frames, height, width, 3)
    return list(canvas.reshape(traffic["pool"], traffic["batch"], height,
                               width, 3).contiguous().unbind(0))
