"""The fused residual-block run (tpu_face_torch/ops/fused_block.py) and
the lowering that puts it on the detectors' path, on the CPU.

* ``fused_blocks_plain`` against restatements of the JAX references in
  the experiment files (which run their TPU benchmark when imported, so
  they are restated here, not imported):
  - f32: ``xla_blocks`` of docs/experiments/fused_block_prototype.py:32-43,
    within 1e-5;
  - bf16: ``xla_blocks`` of docs/experiments/fused_block_v2.py:59-71
    (every op's output in bf16), within 2e-2 * max|ref|: the two
    libraries round the bf16 convolutions' sums at other places.
* The matcher ``_residual_runs``: BACK 28 blocks in 4 runs of 7, FRONT
  and SHORT 5 blocks (a run of 1 and a run of 4), none in the mesh and
  iris nets, and the rules on synthetic graphs.
* ``TFLiteNet`` with its runs against ``tpu_face.compiler.build_jax_fn``
  for BACK, FRONT and SHORT at batch 2, within the detectors' 2e-4.
* The wrapper: CPU tensors take the plain version and never count a
  launch; bad shapes raise; the tiling plan fits shared memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face_torch.compiler import Graph, TFLiteNet, params_from_consts
from tpu_face_torch.compiler.lowering import _residual_runs
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import fused_block

B, H, W, C, L = 2, 16, 16, 8, 3
DETECTORS = ("face_detection_back", "face_detection_front",
             "face_detection_short_range")


def _experiment_inputs(seed=0):
    """The experiment files' inputs at a small size: x NHWC, wd
    [L, 3, 3, C] * 0.2, wp [L, C, C] * 0.2 (out, in), bias [L, C]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    wd = (rng.normal(size=(L, 3, 3, C)) * 0.2).astype(np.float32)
    wp = (rng.normal(size=(L, C, C)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(L, C)).astype(np.float32)
    return x, wd, wp, bias


def _xla_blocks(x, wd, wp, bias, dtype):
    """fused_block_prototype.py:32-43 (dtype f32) and fused_block_v2.py:
    59-71 (dtype bf16): per layer a SAME depthwise 3x3 without bias, a
    1x1 plus one bias, the residual add and the relu."""
    x = jnp.asarray(x).astype(dtype)
    for k in range(wd.shape[0]):
        y = lax.conv_general_dilated(
            x, jnp.asarray(wd[k]).reshape(3, 3, 1, C).astype(dtype), (1, 1),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=C, preferred_element_type=dtype)
        y = lax.conv_general_dilated(
            y, jnp.asarray(wp[k]).T.reshape(1, 1, C, C).astype(dtype),
            (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=dtype) + jnp.asarray(bias[k]).astype(
                dtype)
        x = jnp.maximum(y + x, 0.0)
    return np.asarray(x.astype(jnp.float32))


def _port_args(x, wd, wp, bias, dtype=torch.float32):
    """The same inputs in the port's layout: x NCHW, wd [L, C, 3, 3], the
    depthwise bias zero (the experiments have none)."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
            torch.from_numpy(wd).permute(0, 3, 1, 2),
            torch.zeros(L, C), torch.from_numpy(wp),
            torch.from_numpy(bias))


def test_plain_f32_matches_prototype_reference():
    inputs = _experiment_inputs()
    want = _xla_blocks(*inputs, jnp.float32)
    got = fused_block.fused_blocks_plain(*_port_args(*inputs))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5, np.abs(got - want).max()


def test_plain_bf16_matches_v2_reference():
    inputs = _experiment_inputs(1)
    want = _xla_blocks(*inputs, jnp.bfloat16)
    got = fused_block.fused_blocks_plain(
        *_port_args(*inputs, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    args = _port_args(*_experiment_inputs(2))
    before = fused_block.LAUNCHES
    got = fused_block.fused_blocks(*args)
    assert fused_block.LAUNCHES == before
    assert torch.equal(got, fused_block.fused_blocks_plain(*args))
    # a non-contiguous NCHW view (an NHWC tensor permuted) gives the
    # result of its contiguous copy, to the convolutions' rounding
    assert args[0].is_contiguous() is False
    torch.testing.assert_close(fused_block.fused_blocks(
        args[0].contiguous(), *args[1:]), got, rtol=0, atol=1e-5)


def _bad(name):
    x, wd, bd, wp, bp = _port_args(*_experiment_inputs())
    return {
        "x_3d": (x[0], wd, bd, wp, bp),
        "dw_5x5": (x, torch.zeros(L, C, 5, 5), bd, wp, bp),
        "dw_channels": (x, wd[:, :4], bd, wp, bp),
        "pw_widening": (x, wd, bd, torch.zeros(L, 2 * C, C), bp),
        "bias_layers": (x, wd, bd[:2], wp, bp),
        "layers_mismatch": (x, wd, bd, wp[:2], bp),
        "no_layers": (x, wd[:0], bd[:0], wp[:0], bp[:0]),
        "int_x": (x.to(torch.int32), wd, bd, wp, bp),
    }[name]


@pytest.mark.parametrize("name", ["x_3d", "dw_5x5", "dw_channels",
                                  "pw_widening", "bias_layers",
                                  "layers_mismatch", "no_layers", "int_x"])
def test_bad_shapes_raise(name):
    with pytest.raises((ValueError, TypeError)):
        fused_block.fused_blocks(*_bad(name))


# (C, H, W, layers): the BACK runs, the FRONT/SHORT runs
PLAN_SHAPES = [(24, 128, 128, 7), (24, 64, 64, 7), (48, 32, 32, 7),
               (96, 16, 16, 7), (24, 64, 64, 1), (96, 8, 8, 4)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fits_shared_memory(shape):
    """Every run shape of the detectors gets a tiling that fits the
    card's shared memory by the f32 kernel's formula and covers every
    layer, the same each time, and it is the least modelled time of every
    tiling that fits."""
    c, h, w, layers = shape
    tile, chunks = fused_block.plan(c, h, w, layers)
    assert sum(chunks) == layers and min(chunks) >= 1
    assert fused_block.smem_bytes(c, tile, max(chunks), h, w) <= \
        fused_block.SMEM_LIMIT
    assert fused_block.plan(c, h, w, layers) == (tile, chunks)
    assert chunks == fused_block.split_layers(layers, chunks[0])
    best = fused_block.f32_cost(c, h, w, tile, chunks)
    for per in range(1, layers + 1):
        for t in range(2, max(h, w) + 2, 2):
            if fused_block.smem_bytes(c, t, per, h, w) <= \
                    fused_block.SMEM_LIMIT:
                assert best <= fused_block.f32_cost(
                    c, h, w, t, fused_block.split_layers(layers, per))


def test_f32_smem_formula_counts_the_clipped_box():
    """Two f32 buffers of the box (tile + 2 layers per side, clipped to
    the image and its border), c + 2 floats a pixel for c <= 48 and c + 4
    for c = 96, and two layers' packed weights."""
    c = 96
    weights = 8 * fused_block.blob_floats(c)
    assert fused_block.smem_bytes(c, 8, 2, 16, 16) == \
        8 * 12 * 12 * (c + 4) + weights
    assert fused_block.smem_bytes(c, 16, 7, 16, 16) == \
        8 * 18 * 18 * (c + 4) + weights
    assert fused_block.smem_bytes(24, 16, 3, 128, 128) == \
        8 * 22 * 22 * 26 + 8 * fused_block.blob_floats(24)


def _detector_runs(name):
    """A detector's residual runs: (x, wd, bd, wp, bp), x relu'd normal
    noise at batch 1, the weights the f32 net's own."""
    net = TFLiteNet(Graph(_DATA_DIR / f"{name}.npz"))
    rng = np.random.default_rng(5)
    return [(torch.from_numpy(rng.standard_normal(
        (1, c, h, w), dtype=np.float32)).relu_(),
        *(getattr(net, f"run{k}_{n}") for n in ("wd", "bd", "wp", "bp")))
        for k, (c, h, w, _) in enumerate(net.run_shapes)]


@pytest.fixture(scope="module")
def back_runs():
    """The BACK detector's four runs (``_detector_runs``)."""
    return _detector_runs("face_detection_back")


@pytest.mark.parametrize("run", range(4))
def test_tf32x3_emulation_meets_the_kernel_tolerance(back_runs, run):
    """The f32 kernel's split-TF32 1x1, emulated on the CPU, stays within
    chip_smoke.py's BLOCK_TOL_F32 (1e-4 x max(1, max|plain|)) of the plain
    version over each BACK run with the real weights; a one-pass TF32
    1x1 (the hi products only) does not."""
    _check_tf32x3_emulation(*back_runs[run])


@pytest.mark.parametrize("run", range(2))
@pytest.mark.parametrize("name", ["face_detection_front",
                                  "face_detection_short_range"])
def test_tf32x3_emulation_meets_the_kernel_tolerance_front_short(name, run):
    """The same at the FRONT and SHORT detectors' runs (C=24 at 64x64
    with one block, C=96 at 8x8 with four), whose nets also take the f32
    kernel."""
    _check_tf32x3_emulation(*_detector_runs(name)[run])


def _check_tf32x3_emulation(x, wd, bd, wp, bp):
    c = x.shape[1]
    with torch.inference_mode():
        want = fused_block.fused_blocks_plain(x, wd, bd, wp, bp)
        got = fused_block.fused_blocks_tf32x3(x, wd, bd, wp, bp)
        one = x
        for l in range(wd.shape[0]):
            y = torch.nn.functional.conv2d(one, wd[l, :, None], bd[l],
                                           padding=1, groups=c)
            yh, _ = fused_block.tf32_split(y)
            wh, _ = fused_block.tf32_split(wp[l])
            one = torch.relu(torch.nn.functional.conv2d(
                yh, wh[:, :, None, None], bp[l]) + one)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert 0.0 < err <= tol, (err, tol)
    assert float((one - want).abs().max()) > tol


def test_tf32_split_rounds_to_nearest_away():
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    hi, lo = fused_block.tf32_split(v)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                           1.0 + 2.0 ** -10, 3.0]
    assert torch.equal(hi + lo, v)


@pytest.fixture(scope="module")
def graphs():
    names = DETECTORS + ("face_landmark", "iris_landmark")
    return {n: (JaxGraph(_DATA_DIR / f"{n}.npz"),
                Graph(_DATA_DIR / f"{n}.npz")) for n in names}


@pytest.mark.parametrize("name,runs", [
    ("face_detection_back", [(24, 128, 7), (24, 64, 7), (48, 32, 7),
                             (96, 16, 7)]),
    ("face_detection_front", [(24, 64, 1), (96, 8, 4)]),
    ("face_detection_short_range", [(24, 64, 1), (96, 8, 4)]),
    ("face_landmark", []),
    ("iris_landmark", []),
])
def test_matcher_counts(graphs, name, runs):
    _, g = graphs[name]
    found = _residual_runs(g.ops, g.consts, set(g.outputs))
    assert [(r[0]["c"], g.tensors[r[0]["input"]]["shape"][1], len(r))
            for r in found] == runs
    net = TFLiteNet(g)
    assert [s[0] for s in net.run_shapes] == [c for c, _, _ in runs]


@pytest.mark.parametrize("name", DETECTORS)
def test_net_with_runs_matches_build_jax_fn(graphs, name):
    jg, tg = graphs[name]
    params = params_from_consts(jg.ops, jg.consts)
    net = TFLiteNet(tg, params).eval()
    assert net.runs
    x = np.random.default_rng(7).uniform(
        -1.0, 1.0, (2,) + tuple(jg.input_shape[1:])).astype(np.float32)
    want = jax.jit(build_jax_fn(jg))(x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
        per_op = TFLiteNet(tg, params, fuse_blocks=False).eval()(
            torch.from_numpy(x))
    for g, w, p in zip(got, want, per_op):
        assert tuple(g.shape) == w.shape
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 2e-4
        # on the CPU the runs are the per-op arithmetic, bit for bit
        assert torch.equal(g, p)


def _block_ops(x, out, c, add_order=(0, 1), fused_relu=False, first=100):
    """A synthetic block: DW 3x3 -> 1x1 -> ADD -> RELU, tensor ids from
    ``first``; returns (ops, consts)."""
    dw, pw, add = first, first + 1, first + 2
    consts = {first + 10: np.zeros((1, 3, 3, c), np.float32),
              first + 11: np.zeros((c, 1, 1, c), np.float32)}
    ops = [
        {"op": "DEPTHWISE_CONV_2D", "inputs": [x, first + 10, -1],
         "outputs": [dw], "options": {
             "stride": [1, 1], "dilation": [1, 1], "padding": "SAME",
             "activation": "NONE", "depth_multiplier": 1}},
        {"op": "CONV_2D", "inputs": [dw, first + 11, -1],
         "outputs": [pw], "options": {
             "stride": [1, 1], "dilation": [1, 1], "padding": "VALID",
             "activation": "NONE"}},
        {"op": "ADD", "inputs": [[x, pw][add_order[0]],
                                 [x, pw][add_order[1]]],
         "outputs": [add if not fused_relu else out],
         "options": {"activation": "RELU" if fused_relu else "NONE"}},
    ]
    if not fused_relu:
        ops.append({"op": "RELU", "inputs": [add], "outputs": [out],
                    "options": {}})
    return ops, consts


def _chain(n, c=8, **kw):
    ops, consts = [], {}
    for k in range(n):
        o, cs = _block_ops(k, k + 1, c, first=100 + 20 * k, **kw)
        ops += o
        consts.update(cs)
    return ops, consts


@pytest.mark.parametrize("kw", [{}, {"add_order": (1, 0)},
                                {"fused_relu": True}])
def test_matcher_accepts_operand_order_and_fused_relu(kw):
    ops, consts = _chain(3, **kw)
    runs = _residual_runs(ops, consts, {3})
    assert [len(r) for r in runs] == [3]
    assert runs[0][0]["input"] == 0 and runs[0][-1]["output"] == 3


def test_matcher_splits_runs_at_outside_readers():
    """A block output that is a graph output, or that feeds anything
    besides the next block, ends its run; a width change starts a new
    one."""
    ops, consts = _chain(3)
    assert [len(r) for r in _residual_runs(ops, consts, {1, 3})] == [1, 2]
    extra = ops + [{"op": "RELU", "inputs": [2], "outputs": [99],
                    "options": {}}]
    assert [len(r) for r in _residual_runs(extra, consts, {3, 99})] == \
        [2, 1]
    a, ca = _block_ops(0, 1, 8, first=100)
    b, cb = _block_ops(1, 2, 16, first=200)
    assert [len(r) for r in _residual_runs(a + b, {**ca, **cb}, {2})] == \
        [1, 1]


def test_matcher_rejects_non_blocks():
    """Strided, dilated or activated depthwise convs, a widening 1x1 and
    an intermediate with a second reader match nothing."""
    def variant(edit):
        ops, consts = _chain(1)
        edit(ops, consts)
        return _residual_runs(ops, consts, {1})

    def strided(ops, consts):
        ops[0]["options"]["stride"] = [2, 2]

    def dilated(ops, consts):
        ops[0]["options"]["dilation"] = [2, 2]

    def activated(ops, consts):
        ops[0]["options"]["activation"] = "RELU6"

    def widening(ops, consts):
        consts[111] = np.zeros((16, 1, 1, 8), np.float32)

    def shared(ops, consts):
        ops.append({"op": "RELU", "inputs": [100], "outputs": [98],
                    "options": {}})

    for edit in (strided, dilated, activated, widening, shared):
        assert variant(edit) == [], edit.__name__
