"""The ViT's yardstick (``harness/vit_costs.py``) against a count by hand
on one block, and against the frozen counts (``costs.graph_flops``,
``net_bytes.graph_bytes``) on an IR-ResNet, whose one FC has one row."""

import json

import numpy as np
import pytest

from harness import costs, net_bytes, vit_costs
from models import iresnet, vit

SEED = 2**31 + 41
# one block: 144 tokens of C, H heads, an MLP of M
C, H, M, N = 96, 8, 384, 144


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    """The graph JSON of one block at width C, and its weights."""
    w = vit.draw_weights(SEED, 112, 9, C, 1, H, M, 64)
    graph, consts = vit.block_graph(w, H)
    path = tmp_path_factory.mktemp("vit_block") / "block.npz"
    vit.save_npz(path, {"__graph__": np.array(json.dumps(graph)), **consts})
    return vit_costs.graph_meta(path), w


def test_block_operations_by_hand(block):
    meta, _ = block
    # q, k, v and proj (C x C each), fc1 and fc2 (C x M each) over every
    # token; q k^T and p v, each N x N x C/H a head
    fcs = 2 * N * (4 * C * C + 2 * C * M)
    products = 2 * 2 * H * N * N * (C // H)
    assert vit_costs.graph_flops(meta) == fcs + products == 39_813_120


def test_block_bytes_by_hand(block):
    meta, w = block
    consts = sum(v.size for k, v in w.items() if k.startswith("blocks."))
    # the graph's constants beyond the weights: the two LayerNorms' eps and
    # the attention's scale
    consts += 3
    per_image = (
        3 * (N * C + N * C)             # q, k, v: input and output
        + (N * C + N * C)               # proj
        + (N * C + N * M) + (N * M + N * C)           # fc1, fc2
        + 2 * (H * N * (C // H)) + H * N * N          # q k^T: in, out
        + (H * N * N + H * N * (C // H)) + H * N * (C // H)   # p v
        + 2 * N * C)                    # the two residual ADDs' skips
    for batch in (1, 128):
        assert vit_costs.graph_bytes(meta, batch) == 4 * (
            consts + batch * per_image)


def test_iresnet_counts_are_the_frozen_ones(tmp_path):
    made = iresnet.write(tmp_path, SEED, [1, 1, 1, 1], [16, 32, 64, 128],
                         512, 112)
    path = made / iresnet.GRAPH_FILE
    meta = vit_costs.graph_meta(path)
    assert vit_costs.graph_flops(meta) == costs.graph_flops(path)
    for batch in (1, 128):
        assert vit_costs.graph_bytes(meta, batch) == net_bytes.graph_bytes(
            path, batch)
