"""The port's traffic model (tpu_face_torch/compiler/traffic.py) against
the JAX package's (tpu_face/compiler/traffic.py).

The rows the two models share (the nets, the frame read, the NMS, the
projection) must give JAX's numbers exactly; the card's rows (the planes,
the detection warp, the two gather warps) are pinned by numbers worked
out by hand below.  Graphs only: no net runs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import traffic as jax_traffic
from tpu_face_torch.compiler import Graph, traffic
from tpu_face_torch.ops.warp import make_planes
from tpu_face_torch.utils.image_io import load_image

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tpu_face/data"
GRAPHS = sorted(str(p.relative_to(DATA)) for p in DATA.rglob("*.npz"))
SHARED = ("input_read", "detect_cnn", "mesh_cnn", "iris_cnn", "nms",
          "project")
STAGES = {"input_read", "planes_build", "detect_warp", "detect_cnn", "nms",
          "mesh_warp", "mesh_cnn", "iris_warp", "iris_cnn", "project",
          "total"}


@pytest.fixture(scope="module")
def graphs():
    names = ("face_detection_back.npz", "face_landmark.npz",
             "iris_landmark.npz")
    return ([Graph(DATA / n) for n in names],
            [JaxGraph(DATA / n) for n in names])


def test_every_graph_is_covered():
    """The five detectors, the mesh, the iris and the demo embedding
    graph."""
    assert len(GRAPHS) == 8 and "demo/face_embeddings.npz" in GRAPHS


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_traffic_matches_jax(name):
    ours, ref = Graph(DATA / name), JaxGraph(DATA / name)
    for act_bytes in (2, 4):
        got = traffic.graph_traffic(ours, act_bytes)
        assert got == jax_traffic.graph_traffic(ref, act_bytes), name
        assert got[1] > got[0] > 0 and got[2] > 0
    assert traffic.graph_traffic(ours) == traffic.graph_traffic(ours, 2)


@pytest.mark.parametrize("size,batch", [((540, 360), 128),
                                        ((1920, 1080), 1)])
@pytest.mark.parametrize("act_bytes", [2, 4])
def test_shared_rows_match_jax(graphs, size, batch, act_bytes):
    ours, ref = graphs
    got = traffic.cascade_step_costs(size, batch, *ours,
                                     act_bytes=act_bytes)
    want = jax_traffic.cascade_step_costs(size, batch, *ref,
                                          act_bytes=act_bytes)
    assert set(got) == set(want) == STAGES
    for row in SHARED:
        assert got[row] == want[row], row


@pytest.mark.parametrize("size,batch,act_bytes",
                         [((540, 360), 128, 2), ((1920, 1080), 1, 4),
                          ((3840, 2160), 8, 2), ((1280, 720), 3, 2)])
def test_total_is_the_sum_of_the_stages(graphs, size, batch, act_bytes):
    costs = traffic.cascade_step_costs(size, batch, *graphs[0],
                                       act_bytes=act_bytes)
    tb, tf = costs.pop("total")
    assert tb == sum(b for b, _ in costs.values())
    assert tf == sum(f for _, f in costs.values())
    assert all(b > 0 and f >= 0 for b, f in costs.values())
    bpf = traffic.cascade_bytes_per_frame(size, batch, *graphs[0],
                                          act_bytes=act_bytes)
    assert bpf == tb / batch


def test_act_bytes_defaults_to_bf16(graphs):
    """JAX's default of 2 bytes per activation stays the default."""
    assert (traffic.cascade_bytes_per_frame((540, 360), 4, *graphs[0])
            == traffic.cascade_bytes_per_frame((540, 360), 4, *graphs[0],
                                               act_bytes=2)
            < traffic.cascade_bytes_per_frame((540, 360), 4, *graphs[0],
                                              act_bytes=4))


def test_card_rows_pinned(graphs):
    """The card's rows at 540p (f32 planes, K1) and 1080p (bf16 planes,
    K2), worked out by hand: BACK's 256x256 input, the 192x192 mesh grid,
    two 64x64 iris grids."""
    det, mesh, iris = graphs[0]
    c540 = traffic.cascade_step_costs((540, 360), 1, det, mesh, iris,
                                      act_bytes=4)
    planes = 3 * 360 * 540
    assert c540["planes_build"] == (planes * 4, 0)
    # f32 planes and f32 dots: planes read, [3, 256, 540] written and
    # read, [3, 256, 256] f32 out, the two hat matrices once per step
    t1 = 3 * 256 * 540
    assert c540["detect_warp"] == (
        planes * 4 + t1 * 8 + 3 * 256 * 256 * 4
        + (256 * 360 + 256 * 540) * 4,
        3 * (2 * 256 * 360 * 540 + 2 * 256 * 540 * 256))
    # gathers: the f32 output plus one f32 source pixel per output value
    assert c540["mesh_warp"] == (192 * 192 * 3 * (4 + 4), 0)
    assert c540["iris_warp"] == (2 * 64 * 64 * 3 * (4 + 4), 0)

    planes = 3 * 1080 * 1920
    t1 = 3 * 256 * 1920
    hats = 256 * 1080 + 256 * 1920
    out = 3 * 256 * 256 * 4
    c1080 = traffic.cascade_step_costs((1920, 1080), 2, det, mesh, iris,
                                       act_bytes=2)
    # bf16 planes, not padded (JAX's TPU planes: 3 * 1088 * 1920 * 2)
    assert c1080["planes_build"] == (2 * planes * 2, 0)
    # bf16 nets above 720 px: bf16 dots over the bf16 planes; t1 written
    # as bf16, widened to f32, read as f32; bf16 wy, widened wx per step
    assert c1080["detect_warp"] == (
        2 * (planes * 2 + t1 * (2 + 2 + 4 + 4) + out)
        + 256 * 1080 * 2 + 256 * 1920 * 4,
        2 * 3 * (2 * 256 * 1080 * 1920 + 2 * 256 * 1920 * 256))
    assert c1080["mesh_warp"] == (2 * 192 * 192 * 3 * (4 + 2), 0)
    assert c1080["iris_warp"] == (2 * 2 * 64 * 64 * 3 * (4 + 2), 0)
    # f32 nets at 1080p: the bf16 planes copied to f32 for f32 dots
    c1080 = traffic.cascade_step_costs((1920, 1080), 1, det, mesh, iris,
                                       act_bytes=4)
    assert c1080["detect_warp"][0] == (planes * (2 + 4) + planes * 4
                                       + t1 * 8 + out + hats * 4)
    # 1280x720 keeps f32 planes, but bf16 nets take bf16 dots above
    # 720 px: the f32 planes copied to bf16 first
    planes, t1 = 3 * 720 * 1280, 3 * 256 * 1280
    c720 = traffic.cascade_step_costs((1280, 720), 1, det, mesh, iris)
    assert c720["planes_build"] == (planes * 4, 0)
    assert c720["detect_warp"][0] == (
        planes * (4 + 2) + planes * 2 + t1 * 12 + out
        + 256 * 720 * 2 + 256 * 1280 * 4)


def test_gather_reads_capped_at_the_plane_set(graphs):
    """A frame smaller than the mesh grid: the gather cannot read more
    than the whole plane set."""
    det, mesh, iris = graphs[0]
    c = traffic.cascade_step_costs((128, 96), 1, det, mesh, iris)
    assert c["mesh_warp"] == (192 * 192 * 3 * 4 + 3 * 96 * 128 * 4, 0)
    # the two iris grids read fewer values than the plane set holds
    assert c["iris_warp"] == (2 * 64 * 64 * 3 * (4 + 4), 0)


def test_planes_build_is_make_planes_nbytes(graphs):
    """The planes row is what ``make_planes`` allocates, at 540p (f32)
    and 1080p (bf16), as the cascade's ``_plane_cfg`` picks the type."""
    from tpu_face_torch.pipeline import FaceCascade

    img = load_image(ROOT / "assets/rotated/man_rotp15.png")
    big = np.zeros((1080, 1920, 3), np.uint8)
    big[180:900, 420:1500] = np.repeat(np.repeat(img, 2, 0), 2, 1)
    for frame in (img, big):
        size = (frame.shape[1], frame.shape[0])
        batch = torch.from_numpy(np.stack([frame, frame[:, ::-1]]))
        planes = make_planes(batch, "hwc", FaceCascade._plane_cfg(size))
        costs = traffic.cascade_step_costs(size, 2, *graphs[0])
        assert costs["planes_build"] == (planes.nbytes, 0), size
    assert planes.dtype == torch.bfloat16
