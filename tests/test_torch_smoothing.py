"""tpu_face_torch.smoothing on the CPU against tpu_face.smoothing.

Both smoothers step by step on the same seeded jittered landmark
sequences (a drifting face plus noise), every output within 1e-5
(normalized units), through:

* invalid rows (passed through raw, their state reset) and rows that
  come back;
* a shape change (the state starts afresh) and ``reset()``;
* ``dt`` (real frame times, a dropped frame) against the fixed rate;
* leading multi-face dims [B, K, N, 3];
* the config and ``dt`` validation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face import smoothing as jsm
from tpu_face_torch import smoothing as tsm

TOL = 1e-5


def _sequence(rng, steps, lead, n=478):
    """A face-sized point cloud drifting and jittering over ``steps``
    frames: [steps, *lead, n, 3]."""
    base = rng.uniform(0.3, 0.6, lead + (n, 3))
    drift = np.cumsum(rng.normal(0, 0.004, (steps,) + lead + (1, 3)), 0)
    noise = rng.normal(0, 0.002, (steps,) + lead + (n, 3))
    return (base + drift + noise).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("lead", [(3,), (2, 4)])
def test_landmark_smoother_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    seq = _sequence(rng, 8, lead, n=468)
    valid = rng.uniform(size=(8,) + lead) > 0.2
    valid[:2] = True
    mine = tsm.LandmarkSmoother(device="cpu")
    ref = jsm.LandmarkSmoother()
    dts = [None, None, 1 / 30, 2 / 30, 1 / 60, None, 0.05, 1 / 30]
    for x, v, dt in zip(seq, valid, dts):
        _close(mine(x, v, dt=dt), ref(x, v, dt=dt))
    # every row valid (the default) continues the state
    _close(mine(seq[-1]), ref(seq[-1]))


def test_result_smoother_matches_jax():
    rng = np.random.default_rng(7)
    mesh = _sequence(rng, 6, (2, 3), n=468)
    iris = _sequence(rng, 6, (2, 3), n=10).reshape(6, 2, 3, 2, 5, 3)
    valid = rng.uniform(size=(6, 2, 3)) > 0.25
    mine = tsm.ResultSmoother(tsm.OneEuroConfig(beta=5.0, rate=25.0),
                              device="cpu")
    ref = jsm.ResultSmoother(jsm.OneEuroConfig(beta=5.0, rate=25.0))
    for m, i, v, dt in zip(mesh, iris, valid,
                           (None, 0.04, 0.08, None, 0.02, 0.04)):
        gm, gi = mine(m, i, v, dt=dt)
        wm, wi = ref(m, i, v, dt=dt)
        assert tuple(gm.shape) == m.shape and tuple(gi.shape) == i.shape
        _close(gm, wm)
        _close(gi, wi)


def test_shape_change_and_reset_restart_the_filter():
    rng = np.random.default_rng(3)
    a = _sequence(rng, 4, (2,))
    b = _sequence(rng, 3, (3,))
    mine = tsm.LandmarkSmoother(device="cpu")
    ref = jsm.LandmarkSmoother()
    for x in a[:2]:
        _close(mine(x), ref(x))
    # a new batch size: fresh state, so the first output is the input
    first = mine(b[0])
    _close(first, ref(b[0]))
    np.testing.assert_array_equal(first.numpy(), b[0])
    _close(mine(b[1]), ref(b[1]))
    mine.reset()
    ref.reset()
    np.testing.assert_array_equal(mine(b[2]).numpy(), b[2])
    _close(mine(a[2][:, :468]), ref(a[2][:, :468]))


def test_invalid_rows_pass_through_raw_and_restart():
    rng = np.random.default_rng(4)
    seq = _sequence(rng, 4, (2,))
    mine = tsm.LandmarkSmoother(device="cpu")
    ref = jsm.LandmarkSmoother()
    mine(seq[0])
    ref(seq[0])
    off = np.array([True, False])
    out = mine(seq[1], off)
    _close(out, ref(seq[1], off))
    np.testing.assert_array_equal(out[1].numpy(), seq[1][1])
    assert not np.array_equal(out[0].numpy(), seq[1][0])
    # the stream that comes back starts from its raw input again
    back = mine(seq[2])
    _close(back, ref(seq[2]))
    np.testing.assert_array_equal(back[1].numpy(), seq[2][1])


def test_alpha_and_step_match_jax():
    rng = np.random.default_rng(5)
    cutoff = rng.uniform(0.05, 30.0, 64).astype(np.float32)
    for te in (1 / 30, 0.1):
        got = tsm._alpha(torch.from_numpy(cutoff),
                         torch.tensor(te, dtype=torch.float32))
        want = jsm._alpha(jnp.asarray(cutoff), jnp.float32(te))
        _close(got, want)
    cfg = tsm.OneEuroConfig()
    x, x_hat = _sequence(rng, 2, (3,))
    dx_hat = rng.normal(0, 0.1, x.shape).astype(np.float32)
    cont = np.array([True, False, True])
    te = np.float32(1 / 30)
    got = tsm._one_euro_step(*(torch.from_numpy(a) for a in
                               (x, x_hat, dx_hat, cont)), cfg,
                             torch.tensor(te))
    want = jsm._one_euro_step(*(jnp.asarray(a) for a in
                                (x, x_hat, dx_hat, cont)),
                              jsm.OneEuroConfig(), te)
    for g, w in zip(got, want):
        _close(g, w)


def test_config_and_dt_validation():
    for bad in (dict(min_cutoff=0.0), dict(rate=-1.0),
                dict(derivate_cutoff=0.0)):
        with pytest.raises(ValueError):
            tsm.LandmarkSmoother(tsm.OneEuroConfig(**bad), device="cpu")
        with pytest.raises(AssertionError):
            jsm.LandmarkSmoother(jsm.OneEuroConfig(**bad))
    x = np.full((1, 468, 3), 0.5, np.float32)
    for dt in (0.0, -0.1):
        with pytest.raises(ValueError):
            tsm.LandmarkSmoother(device="cpu")(x, dt=dt)
        with pytest.raises(ValueError):
            jsm.LandmarkSmoother()(x, dt=dt)


def test_smoothers_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsm.LandmarkSmoother()
