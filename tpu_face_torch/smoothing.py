"""Temporal landmark smoothing for video (OneEuro filter; counterpart of
tpu_face/smoothing.py).

Raw per-frame meshes jitter.  The OneEuro filter (Casiez et al., CHI
2012) is an adaptive low-pass whose cutoff rises with speed: static
points are smoothed hard, fast motion stays responsive.  Speed is
measured relative to the face size (the landmark bbox diagonal), as the
upstream landmarks_smoothing_calculator does, so one parameter set works
at every resolution and distance.

Each update is a handful of elementwise torch ops over [..., N, 3]
landmark sets of B streams, with the state on the smoother's device
(the card unless ``device="cpu"``).  On the card they run as one CUDA
graph per input shape (the smoother's ``programs.ProgramCache``; the JAX
version jits its filter), the state and the elapsed time its inputs; on
the CPU eagerly.  The state follows the input's shape: a shape change
starts it afresh, as the JAX version's re-jit per shape does.

>>> smoother = LandmarkSmoother()               # OneEuroConfig()
>>> for frames in video_batches:
...     res = tracker.step(frames)
...     mesh = smoother(res.mesh, res.mesh_valid)
"""

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import resolve_device
from .programs import ProgramCache

__all__ = ["OneEuroConfig", "LandmarkSmoother", "ResultSmoother"]


class OneEuroConfig(NamedTuple):
    """OneEuro parameters (Casiez et al. 2012).

    ``min_cutoff`` (Hz) sets smoothing at rest (lower = steadier);
    ``beta`` scales the cutoff with speed (higher = snappier; speed is in
    face diagonals per second, see ``scale_by_face``);
    ``derivate_cutoff`` (Hz) low-passes the speed estimate itself;
    ``rate`` is the assumed frame rate, used only when the caller passes
    no real inter-frame ``dt``."""

    min_cutoff: float = 0.05
    beta: float = 10.0
    derivate_cutoff: float = 1.0
    rate: float = 30.0
    # measure speed relative to the landmark bbox diagonal, so beta is
    # resolution- and distance-independent
    scale_by_face: bool = True


def _alpha(cutoff, te):
    """EMA coefficient of a first-order low-pass at ``cutoff`` Hz sampled
    ``te`` seconds after the previous sample."""
    tau = 1.0 / (2.0 * math.pi * cutoff)
    return 1.0 / (1.0 + tau / te)


def _one_euro_step(x, x_hat, dx_hat, cont, cfg: OneEuroConfig, te):
    """One filter update over [..., N, C] landmarks.

    ``cont`` [...] marks streams whose state continues from the previous
    frame; the others re-initialize to the raw input.  ``te`` is the
    elapsed time (s) since the previous frame: a dropped frame (2x te)
    doubles both the speed window and the low-pass step."""
    speed_scale = 1.0
    if cfg.scale_by_face:
        ext = (x[..., :2].amax(-2) - x[..., :2].amin(-2))   # [..., 2]
        diag = torch.sqrt((ext * ext).sum(-1))               # [...]
        # a degenerate landmark set (an empty slot's dummy) must not blow
        # the speed estimate up into permanent passthrough
        speed_scale = 1.0 / torch.clamp(diag, min=1e-2)[..., None, None]

    dx = (x - x_hat) / te
    a_d = _alpha(cfg.derivate_cutoff, te)
    dx_f = a_d * dx + (1.0 - a_d) * dx_hat
    cutoff = cfg.min_cutoff + cfg.beta * torch.abs(dx_f) * speed_scale
    a = _alpha(cutoff, te)
    x_f = a * x + (1.0 - a) * x_hat

    cont_b = cont[..., None, None]
    new_hat = torch.where(cont_b, x_f, x)
    new_d = torch.where(cont_b, dx_f, torch.zeros_like(dx_f))
    return new_hat, new_d


def _filter_step(x, valid, x_hat, dx_hat, ok, cfg, te):
    """The stateful update over one [..., N, C] point set: filter the
    continuing streams, pass invalid rows through raw and reset their
    state.  Returns (out, new_x_hat, new_dx_hat, new_ok)."""
    new_hat, new_d = _one_euro_step(x, x_hat, dx_hat, ok & valid, cfg, te)
    vb = valid[..., None, None]
    out = torch.where(vb, new_hat, x)
    return (out, out, torch.where(vb, new_d, torch.zeros_like(new_d)),
            valid)


@functools.lru_cache(maxsize=None)
def _rate_te(rate, device):
    """1/``rate`` seconds as an f32 device scalar, made once per rate and
    device (filled on the device: no host copy)."""
    return torch.full((), 1.0 / rate, dtype=torch.float32, device=device)


class _SmootherBase:
    """Config validation and the (x_hat, dx_hat, ok) state, shared by
    both smoothers."""

    def __init__(self, config: Optional[OneEuroConfig] = None,
                 device=None):
        self.config = config if config is not None else OneEuroConfig()
        if not (self.config.min_cutoff > 0 and self.config.rate > 0
                and self.config.derivate_cutoff > 0):
            raise ValueError(f"min_cutoff, rate and derivate_cutoff must "
                             f"be positive, got {self.config}")
        self.device = resolve_device(device)
        self._state = None  # (x_hat [lead+(N,C)], dx_hat, ok [lead])
        self._cache = ProgramCache(self.device)   # the filter by shape

    def reset(self):
        self._state = None

    def _stored_state(self, shape, dtype, lead):
        """The state if it matches the point set's shape and type, else a
        fresh one (ok False everywhere: the first call initializes to the
        raw input).  Coordinates are normalized, so a caller that re-keys
        its streams at the same shapes (the trackers on a resolution
        change) must call ``reset()`` itself."""
        st = self._state
        if st is None or st[0].shape != shape or st[0].dtype != dtype:
            z = torch.zeros(shape, dtype=dtype, device=self.device)
            st = (z, z, torch.zeros(lead, dtype=torch.bool,
                                    device=self.device))
        return st

    def _te(self, dt):
        """Elapsed seconds since the previous frame as an f32 scalar
        tensor on the device: ``dt=None`` is 1/config.rate (``_rate_te``);
        a given ``dt`` goes to the card through a fresh pinned tensor,
        without waiting on the stream."""
        if dt is None:
            return _rate_te(self.config.rate, self.device)
        te = float(dt)
        if te <= 0:
            raise ValueError(f"dt must be positive, got {dt}")
        host = torch.tensor(te, dtype=torch.float32)
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _valid(self, valid, lead):
        if valid is None:
            return torch.ones(lead, dtype=torch.bool, device=self.device)
        return torch.broadcast_to(self._tensor(valid, torch.bool), lead)


class LandmarkSmoother(_SmootherBase):
    """Stateful OneEuro smoothing over batched landmark streams.

    Call with ``landmarks [..., N, C]`` (leading dims are streams: [B, 468,
    3] from ``FaceTracker``, [B, K, 468, 3] from ``MultiFaceTracker``)
    and ``valid [...]`` per-stream flags; invalid rows pass through raw
    and their state resets, so a re-acquired face restarts its filter.
    The state follows the input's shape: a batch-size change resets it;
    a stream-identity or resolution change at the same shapes needs
    ``reset()``."""

    def _fn(self, x, valid, x_hat, dx_hat, ok, te):
        return _filter_step(x, valid, x_hat, dx_hat, ok, self.config, te)

    def __call__(self, landmarks, valid=None, dt=None):
        """``dt``: seconds since the previous frame; ``None`` assumes
        1/config.rate."""
        x = self._tensor(landmarks)
        lead = x.shape[:-2]
        valid = self._valid(valid, lead)
        st = self._stored_state(x.shape, x.dtype, lead)
        out, *self._state = self._cache("filter", self._fn, x, valid, *st,
                                        self._te(dt))
        return out


class ResultSmoother(_SmootherBase):
    """OneEuro over a tracker result's mesh AND iris landmarks as one
    face-scaled point set of 478 points (a separate iris filter would
    normalize speed by the tiny iris bbox instead of the face's)."""

    def _fn(self, mesh, iris, valid, x_hat, dx_hat, ok, te):
        """The filter over the 478 points, split back into (mesh, iris)
        and the new state."""
        lead, n = mesh.shape[:-2], mesh.shape[-2]
        x = torch.cat([mesh, iris.reshape(*lead, -1, mesh.shape[-1])], -2)
        out, *state = _filter_step(x, valid, x_hat, dx_hat, ok,
                                   self.config, te)
        return (out[..., :n, :], out[..., n:, :].reshape(iris.shape),
                *state)

    def __call__(self, mesh, iris, valid, dt=None):
        mesh = self._tensor(mesh)
        iris = self._tensor(iris)
        lead = mesh.shape[:-2]
        valid = self._valid(valid, lead)
        n = mesh.shape[-2] + math.prod(iris.shape[len(lead):-1])
        st = self._stored_state(lead + (n, mesh.shape[-1]), mesh.dtype, lead)
        mesh, iris, *self._state = self._cache(
            "filter", self._fn, mesh, iris, valid, *st, self._te(dt))
        return mesh, iris
