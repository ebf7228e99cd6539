"""The yardstick's counts against the program's own arithmetic: the nets'
operations (``compiler.graph_flops``) and the fused kernel's runs."""

import json

import pytest

from harness import costs
from helpers import HERE, ROOT

GRAPHS = ("face_detection_back", "face_detection_full_range_sparse",
          "face_landmark", "iris_landmark")


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_flops_match_the_program(name):
    from tpu_face_torch.compiler import Graph, graph_flops

    path = ROOT / "tpu_face" / "data" / f"{name}.npz"
    assert costs.graph_flops(path) == graph_flops(Graph(path))


def test_cascade_flops_per_frame_and_face():
    back = json.loads((HERE / "configs" / "back_f32.json").read_text())
    full = json.loads((HERE / "configs" / "full_sparse_k4_f32.json")
                      .read_text())
    det, face = costs.cascade_flops(back, ROOT)
    assert round(det / 1e6, 1) == 377.5
    assert round(face / 1e6, 1) == 284.6
    assert round((det + face) / 1e6, 1) == 662.1
    det, face = costs.cascade_flops(full, ROOT)
    assert round(det / 1e6, 1) == 234.4
    assert round((det + 4 * face) / 1e6, 1) == 1372.9


def test_fused_runs_are_the_programs():
    from tpu_face_torch.compiler import Graph, build_torch_fn

    back = json.loads((HERE / "configs" / "back_f32.json").read_text())
    net = build_torch_fn(Graph(ROOT / "tpu_face" / "data"
                               / "face_detection_back.npz"), "cpu")
    assert [tuple(r) for r in back["fused_runs"]] == net.run_shapes
    full = json.loads((HERE / "configs" / "full_sparse_k4_f32.json")
                      .read_text())
    assert full["fused_runs"] == []


def test_fused_run_cost():
    from tpu_face_torch.ops import fused_block

    for c in (24, 48, 96):
        pointwise, other, nbytes = costs.fused_run_cost(c, 16, 8, 7, 3)
        assert pointwise + other == 3 * 16 * 8 * 7 * fused_block.block_flops(c)
        assert pointwise == 3 * 16 * 8 * 7 * 2 * c * c
        assert nbytes == 4 * (2 * 3 * 16 * 8 * c + 7 * (c * c + 11 * c))
    back = json.loads((HERE / "configs" / "back_f32.json").read_text())
    # the detector's four runs at b64: the 1x1 products at the split-TF32
    # rate take longest, 0.0897 ms (0.304 ms with every operation at the
    # f32 rate)
    assert costs.fused_bound_s(back["fused_runs"], 64) * 1e3 == \
        pytest.approx(0.0897, abs=5e-5)
    # one C=24 block on one 128x128 activation is bound by its bytes
    assert costs.fused_bound_s([(24, 128, 128, 1)], 1) == \
        pytest.approx(4 * (2 * 24 * 128 * 128 + 24 * 35) / 3.35e12)
