"""Each tracker step as one program (``tpu_face_torch.programs.cond`` and
``tracking``'s ``_step_fn``) and the smoother's cached filter, on the CPU.

* ``programs.cond``: the branch its predicate picks (the eager mode),
  both branches picked by ``torch.where`` inside ``both_branches`` (the
  mode a capture's warm-ups run, which records each cond's output spec in
  the order the conds are entered), nesting in both modes, and the
  ``ValueError`` on branches whose outputs differ in shape, type or tree.
  Its export mode: under ``torch.export`` a ``torch.cond`` node, with an
  identity branch (cloned), NamedTuple operands and outputs, and branches
  that close over a parameter, a buffer, a cached constant and an outer
  result (lifted as inputs), both branches of the exported program
  equal to the eager call; mismatched branches raise ``ValueError``
  there too.
* ``FaceTracker`` and ``MultiFaceTracker(max_faces=2)`` (``repair_batch=1``,
  ``redetect_every=3``, two streams of the rotated 540p sequence) over
  nine steps that take the full path (the first step, forced redetects,
  mass loss), locked steps, repairs that find no face and one that
  re-locks, and an unrepaired lost stream: at each step, from the same
  state, ``step`` (the one-program step, eager here), ``_step_fn`` with
  both sides of each cond run, and the host-branch step (``_step_fn``
  called eagerly, each branch taken by reading its predicate) are
  bit-identical, result and next state.
* With both sides of each cond run the step makes no host read
  (tests/test_torch_bench.py's ``_HostValues``); the host-branch step
  makes them.
* The smoothers' filter through their program cache (the eager stand-in
  of tests/test_torch_programs.py) equals the eager filter, one entry per
  input shape; ``dt=None`` is one device scalar per rate.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from test_rotation_e2e import ROT
from test_torch_bench import _HostValues
from test_torch_programs import _EagerProgram
from test_torch_threads import share_cores  # noqa: F401
from test_torch_tracking import SEQ
from tpu_face_torch import exact_f32, programs
from tpu_face_torch import smoothing as tsmooth
from tpu_face_torch import tracking as ttrack
from tpu_face_torch.utils.image_io import load_image

SIZE = (540, 360)
STREAMS = 2

# (streams blanked, the branch the step takes): repair_batch=1,
# redetect_every=3
STEPS = [((), "full"),                    # the first step (forced too)
         ((), "locked"),
         ((1,), "repair"),                # stream 1 lost, no face found
         ((), "forced"),                  # step 3: the redetect
         ((0, 1), "repair"),              # stream 0 repaired in vain, 1 not
         ((), "mass loss"),               # two lost > one repair pass
         ((), "forced"),                  # step 6
         ((1,), "repair"),
         ((), "repair")]                  # stream 1 re-locked by the repair
# the streams locked after each step
LOCKED = [[True, True], [True, True], [True, False], [True, True],
          [False, False], [True, True], [True, True], [True, False],
          [True, True]]


def test_cond_takes_the_branch():
    calls = []

    def branch(name, sign):
        def fn(x):
            calls.append(name)
            return (x * sign,)
        return fn

    x = torch.arange(3.0)
    for flag, want in ((True, "true"), (False, "false")):
        calls.clear()
        (out,) = programs.cond(torch.tensor(flag), branch("true", 1),
                               branch("false", -1), (x,))
        assert calls == [want]
        assert torch.equal(out, x if flag else -x)


def test_cond_runs_both_branches_in_both_mode():
    x = torch.arange(4.0)
    for flag in (True, False):
        calls = []

        def true_fn(x):
            calls.append("true")
            return {"a": x + 1, "b": x > 1}

        def false_fn(x):
            calls.append("false")
            return {"a": x - 1, "b": x < 1}

        with programs.both_branches() as specs:
            out = programs.cond(torch.tensor(flag), true_fn, false_fn, (x,))
        assert calls == ["true", "false"]
        want = true_fn(x) if flag else false_fn(x)
        assert torch.equal(out["a"], want["a"])
        assert torch.equal(out["b"], want["b"])
        ((tree, metas),) = specs
        assert metas == [(torch.Size([4]), torch.float32, x.device),
                         (torch.Size([4]), torch.bool, x.device)]


@pytest.mark.parametrize("both", [False, True])
def test_cond_nests(both):
    x = torch.arange(3.0)

    def outer(p, q):
        def inner(x):
            return programs.cond(q, lambda y: (y * 10,), lambda y: (y + 10,),
                                 (x,))
        return programs.cond(p, inner, lambda y: (-y,), (x,))[0]

    for p, q in ((True, True), (True, False), (False, True)):
        want = (x * 10 if q else x + 10) if p else -x
        if both:
            with programs.both_branches() as specs:
                got = outer(torch.tensor(p), torch.tensor(q))
            # the outer cond's slot first, in the order they were entered
            assert len(specs) == 2 and all(s is not None for s in specs)
        else:
            got = outer(torch.tensor(p), torch.tensor(q))
        assert torch.equal(got, want), (p, q)


@pytest.mark.parametrize("case", ["shape", "dtype", "tree"])
def test_cond_mismatched_outputs_raise(case):
    x = torch.zeros(3)
    other = {"shape": lambda x: (torch.zeros(4),),
             "dtype": lambda x: (x.double(),),
             "tree": lambda x: (x, x)}[case]
    with programs.both_branches(), pytest.raises(ValueError, match="differ"):
        programs.cond(torch.tensor(True), lambda x: (x,), other, (x,))


_CONST = torch.linspace(-1.0, 1.0, 4)     # a cached constant


class _Conds(torch.nn.Module):
    """Two conds: a ``TrackerState`` through a branch that closes over a
    parameter, a buffer, ``_CONST`` and an outer result, or through an
    identity branch; then a tensor through two branches."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(0.5, 2.0, 16)
                                    .reshape(4, 4), requires_grad=False)
        self.register_buffer("b", torch.arange(4.0))

    def forward(self, x, p, q):
        y = x * 3.0
        state = ttrack.TrackerState(x, x > 0)

        def mixed(state, scale):
            return state._replace(roi=state.roi @ self.w + self.b + _CONST
                                  + y * scale)

        state = programs.cond(p, mixed, lambda state, scale: state,
                              (state, x[0, :1]))
        (z,) = programs.cond(q, lambda m: (m.sum(0) - 1.0,),
                             lambda m: (m.amax(0),), (state.roi,))
        return state.roi, state.valid, z


def test_cond_exports_as_torch_cond():
    mod = _Conds()
    x = torch.linspace(-2.0, 2.0, 12).reshape(3, 4)
    with torch.no_grad():
        ep = torch.export.export(mod, (x, torch.tensor(True),
                                       torch.tensor(True)), strict=False)
    conds = [n for n in ep.graph.nodes
             if n.target is torch.ops.higher_order.cond]
    assert len(conds) == 2
    run = ep.module()
    for p, q in ((True, True), (True, False), (False, True),
                 (False, False)):
        args = (x, torch.tensor(p), torch.tensor(q))
        _same(run(*args), mod(*args), (p, q))


def test_cond_export_refuses_mismatched_branches():
    class Odd(torch.nn.Module):
        def forward(self, x, p):
            return programs.cond(p, lambda x: (x,), lambda x: (x.double(),),
                                 (x,))

    with pytest.raises(ValueError, match="differ"):
        torch.export.export(Odd(), (torch.zeros(3), torch.tensor(True)),
                            strict=False)


@pytest.fixture(scope="module")
def frames():
    return {n: load_image(ROT / n) for n in set(SEQ)}


def _batch(frames, step, blank):
    """Step ``step``'s frames: stream s shifted 4*s px right, the streams
    in ``blank`` black."""
    out = []
    for s in range(STREAMS):
        f = np.roll(frames[SEQ[step % len(SEQ)]], 4 * s, axis=1)
        out.append(np.zeros_like(f) if s in blank else f)
    return torch.from_numpy(np.stack(out))


def _tracker(kind):
    kw = dict(device="cpu", repair_batch=1, redetect_every=3)
    if kind == "multiface":
        return ttrack.MultiFaceTracker(max_faces=2, **kw)
    return ttrack.FaceTracker(**kw)


def _same(a, b, label):
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=label)


def _host_step(tracker, images):
    """``_step_fn`` called eagerly: each cond reads its predicate."""
    force = ttrack._force_flags(tracker.device)[tracker.next_step_forced]
    with torch.inference_mode(), exact_f32():
        return tracker._step_fn(images, *tracker._state, force, SIZE)


def _both_step(tracker, images):
    """``_step_fn`` with both sides of each cond run."""
    force = ttrack._force_flags(tracker.device)[tracker.next_step_forced]
    with torch.inference_mode(), exact_f32(), programs.both_branches():
        return tracker._step_fn(images, *tracker._state, force, SIZE)


@pytest.mark.parametrize("kind", ["face", "multiface"])
def test_one_program_step_matches_the_host_branch_step(frames, kind):
    mine = _tracker(kind)
    for i, (blank, branch) in enumerate(STEPS):
        images = _batch(frames, i, blank)
        label = f"{kind} step {i} ({branch})"
        if mine._state is None:
            mine._state = mine._empty_state(STREAMS)
            mine._state_hw = SIZE[::-1]
        entry = (mine._state, mine._steps)
        host = _host_step(mine, images)
        both = _both_step(mine, images)
        res = mine.step(images)
        assert mine._steps == entry[1] + 1
        _same((res, mine._state), host, label)
        _same((res, mine._state), both, label)
        assert mine.tracking.tolist() == LOCKED[i], label


@pytest.mark.parametrize("kind", ["face", "multiface"])
def test_step_makes_no_host_read_with_both_branches(frames, kind):
    tracker = _tracker(kind)
    images = _batch(frames, 0, ())
    tracker.step(images)
    # a warm-up makes the lazy constants (_dummy_roi), as a capture's do
    _both_step(tracker, images)
    for state in (tracker._state, tracker._empty_state(STREAMS)):
        tracker._state = state
        with _HostValues() as mode:
            _both_step(tracker, images)
        assert mode.seen == [], kind
    with _HostValues() as mode:
        _host_step(tracker, images)
    assert mode.seen == ["aten.is_nonzero.default"] * 2, mode.seen


@pytest.fixture
def cached(monkeypatch):
    monkeypatch.setattr(programs, "Program", _EagerProgram)


@pytest.mark.parametrize("which", ["landmark", "result"])
def test_cached_smoother_matches_eager(cached, which):
    rng = np.random.default_rng(5)
    cls = (tsmooth.LandmarkSmoother if which == "landmark"
           else tsmooth.ResultSmoother)
    mine, plain = cls(device="cpu"), cls(device="cpu")
    mine._cache.on_card = True
    for b, dt in ((3, None), (3, 1 / 30), (3, 1 / 15), (3, None), (2, None),
                  (2, 0.05)):
        mesh = torch.from_numpy(rng.uniform(0.3, 0.7, (b, 468, 3))
                                .astype(np.float32))
        valid = torch.from_numpy(rng.uniform(size=b) > 0.2)
        if which == "landmark":
            args = (mesh, valid)
        else:
            iris = torch.from_numpy(rng.uniform(0.3, 0.7, (b, 2, 5, 3))
                                    .astype(np.float32))
            args = (mesh, iris, valid)
        _same(mine(*args, dt=dt), plain(*args, dt=dt), f"{which} b{b} {dt}")
        _same(mine._state, plain._state, f"{which} state b{b} {dt}")
    # one program per input shape
    assert sorted(k[1][0][0] for k in mine._cache.entries) == [2, 3]
    assert plain._cache.entries == {}
    assert mine._te(None) is mine._te(None)
    assert mine._te(None).item() == np.float32(1 / mine.config.rate)
    assert mine._te(0.05).item() == np.float32(0.05)
