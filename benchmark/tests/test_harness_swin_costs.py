"""The Swin's yardstick (``harness/swin_costs.py``) on the published
graph against a count by hand, and its metrics (``embed.window_ms``,
``swin.net_roofline``, ``swin_step.mfu_pct``) on a collection with and
without the program's spans."""

import json

import numpy as np
import pytest

from harness import core, costs, swin_costs, vit_costs
from models import swin

DETECTOR = "face_detection_full_range_sparse.npz"

SEED = 2**31 + 43
TOKENS = ((56, 96), (28, 192), (14, 384), (7, 768))   # grid side, width


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The directory of the published graph (``model_dir`` of a
    configuration named ``swin_s``) and its graph JSON."""
    root = tmp_path_factory.mktemp("swin_root")
    data = root / "tpu_face" / "data"
    data.mkdir(parents=True)
    (data / DETECTOR).symlink_to(core.HERE.parent / "tpu_face" / "data"
                                 / DETECTOR)
    config = {"name": "swin_s", "weights_seed": SEED,
              "graphs": {"detector": DETECTOR},
              "widths": {"input": [224, 224], "patch": 4, "dim": 96,
                         "depths": [2, 2, 18, 2], "heads": [3, 6, 12, 24],
                         "window": 7, "mlp_ratio": 4, "embedding": 512}}
    made = swin.write_config(config, root, files=(swin.GRAPH_FILE,))
    return root, config, swin_costs.graph_meta(made / swin.GRAPH_FILE)


def test_operations_by_hand(published):
    _, _, meta = published
    fcs = attn = 0
    for (res, c), depth in zip(TOKENS, (2, 2, 18, 2)):
        n = res * res
        fcs += depth * n * 12 * c * c
        attn += depth * 2 * n * 49 * c
    merges = sum((res * res // 4) * 4 * c * 2 * c for res, c in TOKENS[:3])
    head = 49 * 768 * 768 + 768 * 512
    patch = 56 * 56 * 96 * 48
    macs = fcs + attn + merges + head + patch
    assert swin_costs.graph_flops(meta) == 2 * macs == 17_538_803_712
    assert swin_costs.graph_flops(meta) == vit_costs.graph_flops(meta)


def test_bytes_by_hand(published):
    _, _, meta = published
    shapes = [t["shape"] for t in meta["tensors"]]
    made = {i for op in meta["ops"] for i in op["outputs"]}
    consts = sum(int(np.prod(shapes[i])) for op in meta["ops"]
                 for i in set(op["inputs"])
                 if i not in made and i not in meta["inputs"]
                 and meta["tensors"][i]["dtype"].startswith("float"))
    per_image = 0
    for (res, c), depth in zip(TOKENS, (2, 2, 18, 2)):
        n = res * res
        blk = (3 * 2 * n * c            # q, k, v: input and output
               + 2 * n * c              # proj
               + 2 * (n * c + 4 * n * c)            # fc1, fc2
               + 2 * n * c + 3 * n * 49          # q k^T: in, out (heads
               + 3 * n * 49 + 2 * n * c          # of 32); p v: in, out
               + 2 * n * c)             # the two residual skips
        # n * 49 logits a head: c / 32 heads
        blk += (c // 32 - 3) * 2 * n * 49
        per_image += depth * blk
    per_image += sum(n * 4 * c + n * 2 * c for n, c in
                     ((r * r // 4, c) for r, c in TOKENS[:3]))   # merges
    per_image += 224 * 224 * 3 + 56 * 56 * 96           # the patch conv
    per_image += 49 * 768 + 768 + 768 + 512              # the head
    for batch in (1, 128):
        assert swin_costs.graph_bytes(meta, batch) == 4 * (
            consts + batch * per_image)
    # vit_costs leaves each tensor's leading axis out: an image's windows
    assert vit_costs.graph_bytes(meta, 128) < swin_costs.graph_bytes(meta,
                                                                     128)


def _ctx(root, config, spans):
    return {"config": dict(config, max_faces=4), "root": root,
            "traffic": {"batch": 32}, "spans": spans, "counts": [10, 10],
            "reference_faces": [3.5, 4.0], "frames": 20 * 32,
            "window_s": 51.0}


def _collection(embed_ns, window_ns):
    graph = {"kind": "device", "name": "programs.graph", "start_ns": 0,
             "end_ns": embed_ns + 10}
    spans = [graph,
             {"kind": "device", "name": "embed", "start_ns": 5,
              "end_ns": 5 + embed_ns},
             {"kind": "device", "name": "net.window", "start_ns": 6,
              "end_ns": 6 + window_ns}]
    return {"spans": spans}


def test_metrics_read_nothing_without_the_spans(published):
    root, config, _ = published
    for name in ("embed.window_ms", "swin.net_roofline"):
        read = core.load_module(core.HERE / "metrics" / f"{name}.py").read
        assert read(_ctx(root, config, None)) is None
        assert read(_ctx(root, config, {"spans": []})) is None


def test_metrics_read_the_spans_and_the_window(published):
    root, config, meta = published
    ctx = _ctx(root, config, _collection(50_000_000, 9_000_000))

    def read(name):
        return core.load_module(core.HERE / "metrics"
                                / f"{name}.py").read(ctx)

    assert read("embed.window_ms") == pytest.approx(9.0)
    flops = swin_costs.graph_flops(meta) * 128
    want = 100 * max(flops / 165e12,
                     swin_costs.graph_bytes(meta, 128) / 3.35e12) / 0.05
    assert read("swin.net_roofline") == pytest.approx(want)
    det = costs.graph_flops(root / "tpu_face" / "data" / DETECTOR) * 640
    net = swin_costs.graph_flops(meta) * (10 * 3.5 + 10 * 4.0)
    assert read("swin_step.mfu_pct") == pytest.approx(
        100 * (det + net) / (51.0 * 165e12))
