"""The kernels as registered PyTorch operators
(``torch.ops.tpu_face_torch.*``, tpu_face_torch/ops/warp.py and
tpu_face_torch/ops/fused_block.py), on the CPU.

* Each operator on CPU tensors equals its plain version exactly: the
  segment warp (K1), the strip warp over bf16 and f32 planes (K2), and
  the fused residual run in f32 (K3) and bf16 (K4), which unpacks the
  kernel's packed weights (an exact packing) before the plain run.
* Each fake implementation gives the real output's shape and dtype.
* ``torch.export`` of a CPU ``FaceCascade(warp_method="pallas")`` holds
  the operator nodes the card's program launches: at 540x360 f32, 2 K1
  nodes and the BACK detector's 4 runs, whose ``chunks`` add up to its 13
  fused launches, and one convolution epilogue node for each of the f32
  nets' 81 chains; with bf16 nets, 4 runs adding up to 8 and no
  epilogue; at 1920x1080 planar (bf16 planes), 2 K2 nodes.  The JAX
  package's numbers are its own; these counts are the port's plan
  (``TFLiteNet.fused_launches``).
* An export leaves the live cascade on the operators (the lowering's
  run bookkeeping survives the tracer's copies of its containers), and
  with the profiling labels on it neither fails nor leaves profiler
  nodes.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.ops import fused_block, warp
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils import profiling

OPS = torch.ops.tpu_face_torch


def _planes(rng, b, h, w, dtype=torch.float32):
    return torch.from_numpy(rng.uniform(0, 255, (b, 3, h, w)).astype(
        np.float32)).to(dtype)


def _coords(rng, shape, h, w):
    """Coordinates [shape] reaching a few pixels past every edge."""
    return (torch.from_numpy(rng.uniform(-3, w + 3, shape).astype(
        np.float32)),
            torch.from_numpy(rng.uniform(-3, h + 3, shape).astype(
                np.float32)))


def _segments_case(rng):
    planes = _planes(rng, 2, 23, 31)
    grids = [_coords(rng, (2, 9, 7), 23, 31), _coords(rng, (2, 2, 5, 5),
                                                       23, 31)]
    return planes, [(x, y, x.shape[-1]) for x, y in grids]


def _fused_case(rng, dtype, c=8, layers=3):
    x = torch.from_numpy(rng.normal(size=(2, c, 12, 10)).astype(
        np.float32)).to(dtype)
    wd = torch.from_numpy((rng.normal(size=(layers, c, 3, 3)) * 0.2)
                          .astype(np.float32))
    bd = torch.from_numpy(rng.normal(size=(layers, c)).astype(np.float32))
    wp = torch.from_numpy((rng.normal(size=(layers, c, c)) * 0.2)
                          .astype(np.float32))
    bp = torch.from_numpy(rng.normal(size=(layers, c)).astype(np.float32))
    if dtype == torch.bfloat16:     # a bf16 net's weights are bf16
        wd, bd, wp, bp = (t.to(dtype) for t in (wd, bd, wp, bp))
    return x, (wd, bd, wp, bp)


def test_segments_op_is_the_plain_version():
    planes, segments = _segments_case(np.random.default_rng(0))
    got = OPS.warp_bilinear_segments(planes, [s[0] for s in segments],
                                     [s[1] for s in segments],
                                     [s[2] for s in segments])
    assert torch.equal(got, warp.warp_bilinear_segments_plain(planes,
                                                              segments))
    assert torch.equal(warp.warp_bilinear_segments(planes, segments), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strips_op_is_the_plain_version(dtype):
    rng = np.random.default_rng(1)
    planes = _planes(rng, 2, 19, 27, dtype)
    xs, ys = _coords(rng, (2, 150), 19, 27)
    got = OPS.warp_bilinear_strips(planes, xs, ys)
    assert got.dtype == torch.float32
    assert torch.equal(got, warp.warp_bilinear_strips_plain(planes, xs, ys))
    assert torch.equal(warp.warp_bilinear_strips(planes, xs, ys), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_op_is_the_plain_version(dtype):
    x, weights = _fused_case(np.random.default_rng(2), dtype)
    (packed,) = fused_block.kernel_weights(*weights, dtype)
    tile, chunks = fused_block.plan(8, 12, 10, 3, x.element_size())
    got = OPS.fused_blocks(x, packed, tile, list(chunks))
    assert got.dtype == dtype
    assert torch.equal(got, fused_block.fused_blocks_plain(x, *weights))
    before = (fused_block.LAUNCHES, fused_block.BF16_LAUNCHES)
    assert torch.equal(fused_block.fused_blocks(x, *weights), got)
    assert (fused_block.LAUNCHES, fused_block.BF16_LAUNCHES) == before


def test_unpack_f32_inverts_pack_f32():
    _, weights = _fused_case(np.random.default_rng(3), torch.float32, c=24)
    for got, want in zip(fused_block.unpack_f32(
            fused_block.pack_f32(*weights), 24), weights):
        assert torch.equal(got, want)


def _op_calls(rng):
    """(name, operator, args) of one call of each operator."""
    planes, segments = _segments_case(rng)
    bf16 = _planes(rng, 2, 19, 27, torch.bfloat16)
    xs, ys = _coords(rng, (2, 150), 19, 27)
    calls = [("segments", OPS.warp_bilinear_segments,
              (planes, [s[0] for s in segments], [s[1] for s in segments],
               [s[2] for s in segments])),
             ("strips", OPS.warp_bilinear_strips, (bf16, xs, ys))]
    for dtype in (torch.float32, torch.bfloat16):
        x, weights = _fused_case(rng, dtype)
        (packed,) = fused_block.kernel_weights(*weights, dtype)
        calls.append((f"fused_{str(dtype)[6:]}", OPS.fused_blocks,
                      (x, packed, 6, [2, 1])))
    return calls


@pytest.mark.parametrize("index", range(4))
def test_fake_gives_the_real_shape_and_dtype(index):
    name, op, args = _op_calls(np.random.default_rng(4))[index]
    real = op(*args)
    mode = FakeTensorMode()

    def fake(a):
        if isinstance(a, torch.Tensor):
            return mode.from_tensor(a)
        if isinstance(a, list):
            return [fake(v) for v in a]
        return a

    fake_args = [fake(a) for a in args]
    with mode:
        out = op(*fake_args)
    assert (tuple(out.shape), out.dtype) == (tuple(real.shape),
                                             real.dtype), name


def test_wrappers_refuse_other_devices():
    planes = torch.zeros(1, 3, 4, 4, device="meta")
    xs = torch.zeros(1, 5, device="meta")
    with pytest.raises(ValueError, match="no warp kernel"):
        warp.warp_bilinear_strips(planes, xs, xs)
    with pytest.raises(ValueError, match="no warp kernel"):
        warp.warp_bilinear_segments(planes, [(xs, xs, 5)])
    x, weights = _fused_case(np.random.default_rng(5), torch.float32)
    with pytest.raises(ValueError, match="no fused block kernel"):
        fused_block.fused_blocks(x.to("meta"),
                                 *(w.to("meta") for w in weights))


def _kernel_nodes(ep):
    """{operator: [node args after the tensors]} of an exported graph."""
    nodes = {}
    for n in ep.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("tpu_face_torch."):
            nodes.setdefault(name.split(".")[1], []).append(n.args)
    return nodes


def _exported(cascade, size, batch=1):
    from tpu_face_torch import aot

    w, h = size
    shape = ((batch, 3, h, w) if cascade._layout == "planar"
             else (batch, h, w, 3))
    return aot._export(cascade.export_module(size),
                       (torch.zeros(shape, dtype=torch.uint8),))


@pytest.fixture(scope="module")
def cascades():
    return {dtype: FaceCascade(compute_dtype=dtype, warp_method="pallas",
                               device="cpu")
            for dtype in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype,launches", [(torch.float32, 13),
                                            (torch.bfloat16, 8)])
def test_export_holds_the_kernel_operators_540p(cascades, dtype, launches):
    cascade = cascades[dtype]
    nodes = _kernel_nodes(_exported(cascade, (540, 360), batch=2))
    # one epilogue a chain of the f32 nets (the detector's 5, the mesh's
    # 23, the iris's 53); a bf16 net has none
    epilogues = nodes.pop("conv_epilogue", [])
    assert len(epilogues) == (81 if dtype == torch.float32 else 0)
    assert len(epilogues) == sum(len(getattr(cascade, n).chains)
                                 for n in cascade._net_names)
    assert set(nodes) == {"warp_bilinear_segments", "fused_blocks"}
    assert len(nodes["warp_bilinear_segments"]) == 2
    # the mesh grid as one segment, both iris grids as two
    assert [len(a[3]) for a in nodes["warp_bilinear_segments"]] == [1, 2]
    runs = nodes["fused_blocks"]
    assert len(runs) == 4
    assert sum(len(a[3]) for a in runs) == launches
    assert launches == cascade._det_net.fused_launches()
    assert [(a[2], tuple(a[3])) for a in runs] == [
        (tile, tuple(chunks)) for tile, chunks in cascade._det_net.run_tilings]


def test_export_holds_the_strip_operator_1080p_planar():
    cascade = FaceCascade(warp_method="pallas", input_layout="planar",
                          device="cpu")
    nodes = _kernel_nodes(_exported(cascade, (1920, 1080)))
    assert len(nodes.pop("warp_bilinear_strips")) == 2
    assert sum(len(a[3]) for a in nodes.pop("fused_blocks")) == 13
    assert len(nodes.pop("conv_epilogue")) == 81
    assert nodes == {}


def test_export_leaves_the_live_cascade_on_the_operators(cascades):
    """torch.export swaps a module's containers for copies while it
    traces; the lowering's run bookkeeping must not depend on their
    identity, or the live net runs its residual runs op by op after an
    export."""
    cascade = cascades[torch.float32]
    frames = torch.zeros(1, 360, 540, 3, dtype=torch.uint8)
    calls = []
    real = fused_block.fused_op

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    _exported(cascade, (540, 360))
    fused_block.fused_op = spy
    try:
        cascade.infer_batch(frames)
    finally:
        fused_block.fused_op = real
    assert sum(len(chunks) for chunks in calls) == 13
    assert len(calls) == 4


def test_export_with_profiling_labels(cascades):
    was = profiling.enabled()
    profiling.enable(True)
    try:
        ep = _exported(cascades[torch.float32], (540, 360))
    finally:
        profiling.enable(was)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert not [t for t in targets if "profiler" in t or "record" in t]
    assert len(_kernel_nodes(ep)["fused_blocks"]) == 4
