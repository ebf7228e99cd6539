"""The lowered nets' convolution epilogues on the CPU
(``compiler.lowering._epilogue_chains``, ``ops.conv_epilogue``):

* the chains found in each bundled graph, by op;
* no chain absorbs a graph output, a tensor with a second user, or an op
  of a residual run, and none is a convolution alone with its bias; ``fuse_blocks=False`` gives the runs' 1x1
  convolutions chains of their own;
* bf16 nets and ``fuse_epilogues=False`` have none;
* an ADD of two single-user convolutions (a downsampling unit's conv
  and its 1x1 shortcut) ends one chain, the later conv's, and the net
  equals the op-by-op one; the two benchmark configurations' nets hold
  81 chains absorbing 136 ops (``back_f32``) and 123 absorbing 142
  (``full_sparse_k4_f32``);
* the fused forward of every bundled f32 graph equals the op-by-op one
  within the f32 rounding of the bias add (oneDNN adds a bias inside the
  convolution, the epilogue after it), in either input layout;
* the operator's plain version against the ops it replaces, the output's
  layout where the skip comes first, and the operand checks;
* ``torch.export`` of a net with chains holds one operator node a chain
  (its fake implementation) and runs as the live net;
* the chains and the ops they absorb, over the nets built;
* a skip made in the graph's own layout (a RESHAPE's output, which the
  net turns NCHW as every 4-D activation) is read as the op-by-op ADD
  reads it.
The kernel itself is held to the op-by-op path on the card by
``tests/test_torch_epilogue_card.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_kernel_abi import ENTRIES
from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.compiler.lowering import (Graph, TFLiteNet, _consumers,
                                              _prelu)
from tpu_face_torch.ops import conv_epilogue as ce

DATA = Path(__file__).resolve().parents[1] / "tpu_face" / "data"
# graph -> (chains, graph ops the chains hold by op)
CHAINS = {
    "face_detection_back": (5, {"CONV_2D": 5, "RELU": 5, "ADD": 3,
                                "PAD": 2}),
    "face_detection_front": (12, {"CONV_2D": 12, "RELU": 12, "ADD": 11,
                                  "PAD": 11}),
    "face_detection_short_range": (12, {"CONV_2D": 12, "RELU": 12,
                                        "ADD": 11, "PAD": 11}),
    "face_detection_full_range": (47, {"CONV_2D": 47, "RELU": 47,
                                       "ADD": 20, "PAD": 8}),
    # its ReLUs are the convs' and ADDs' own activations
    "face_detection_full_range_sparse": (47, {"CONV_2D": 47, "ADD": 16}),
    "face_landmark": (23, {"CONV_2D": 23, "PRELU": 23, "ADD": 20,
                           "PAD": 3}),
    "iris_landmark": (53, {"CONV_2D": 53, "PRELU": 53, "ADD": 26,
                           "PAD": 1}),
    "demo/face_embeddings": (11, {"CONV_2D": 11, "ADD": 9}),
}
_NETS = {}


def _graph_and_net(name):
    if name not in _NETS:
        graph = Graph(DATA / f"{name}.npz")
        _NETS[name] = graph, TFLiteNet(graph).eval()
    return _NETS[name]


@pytest.mark.parametrize("name", CHAINS)
def test_chain_counts(name):
    _, net = _graph_and_net(name)
    chains, by_op = CHAINS[name]
    assert len(net.chains) == chains
    assert net.epilogue_counts == by_op


@pytest.mark.parametrize("name", CHAINS)
def test_chains_cross_no_output_shared_tensor_or_run(name):
    graph, net = _graph_and_net(name)
    users = _consumers(graph.ops)
    pos = {id(node): i for i, node in enumerate(graph.ops)}
    in_runs = net._in_run | set(net._run_start)
    for chain in net.chains:
        ops = chain["ops"]
        assert ops[0]["op"] == "CONV_2D" and ops[0] is chain["conv"]
        # a conv alone with no activation (its bias only) is no chain
        assert len(ops) > 1 or chain["act"] != "NONE"
        assert not {pos[id(n)] for n in ops} & in_runs
        assert ops[-1]["outputs"][0] == chain["output"]
        # every tensor the chain keeps inside is read by the chain's next
        # op alone and is no graph output
        inner = [n for n in ops if n["op"] != "PAD"]
        for node, nxt in zip(inner, inner[1:]):
            t = node["outputs"][0]
            assert t not in graph.outputs
            assert users[t] == [nxt]
        for node in ops:
            if node["op"] == "PAD":
                t = node["outputs"][0]
                assert t not in graph.outputs and users[t] == [
                    n for n in ops if n["op"] == "ADD"]
                assert chain["skip"] == node["inputs"][0]


def test_runs_unfused_give_their_convs_chains():
    graph = Graph(DATA / "face_detection_back.npz")
    net = TFLiteNet(graph, fuse_blocks=False)
    assert not net.runs
    # BACK's 28 residual blocks each add a chain (1x1, ADD, RELU)
    assert len(net.chains) == 33
    assert net.epilogue_counts == {"CONV_2D": 33, "RELU": 33, "ADD": 31,
                                   "PAD": 2}


@pytest.mark.parametrize("name", ["face_detection_back", "face_landmark",
                                  "iris_landmark"])
def test_bf16_and_unfused_nets_have_no_chains(name):
    graph = Graph(DATA / f"{name}.npz")
    for net in (TFLiteNet(graph, compute_dtype=torch.bfloat16),
                TFLiteNet(graph, fuse_epilogues=False)):
        assert net.chains == [] and net.epilogue_counts == {}


@pytest.mark.parametrize("name", CHAINS)
def test_fused_forward_matches_op_by_op(name):
    graph, fused = _graph_and_net(name)
    plain = TFLiteNet(graph, fuse_epilogues=False).eval()
    rng = np.random.default_rng(3)
    for channel_major in (False, True):
        x = torch.from_numpy(rng.random((3,) + graph.input_shape[1:],
                                        dtype=np.float32))
        if channel_major:
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        with torch.inference_mode():
            got, want = fused(x), plain(x)
        for g, w in zip(got, want):
            # f32 rounding of the bias add, carried through the net
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=2e-6 * max(scale, 1.0))


def _reshape_skip_graph(path, h, w, c, skip_first):
    """A graph whose chain's skip is a RESHAPE's output, made in the
    graph's own layout (NHWC): x -> RESHAPE -> skip; x -> CONV_2D 1x1 ->
    ADD(conv, skip) -> PRELU."""
    rng = np.random.default_rng(h * w + c)
    act = [1, h, w, c]
    meta = {
        "inputs": [0], "outputs": [7],
        "tensors": [{"shape": s, "dtype": "float32"} for s in (
            act, act, [c, 1, 1, c], [c], act, act, [1, 1, c], act)],
        "ops": [
            {"op": "RESHAPE", "inputs": [0], "outputs": [1],
             "options": {"new_shape": act}},
            {"op": "CONV_2D", "inputs": [0, 2, 3], "outputs": [4],
             "options": {"stride": [1, 1], "dilation": [1, 1],
                         "padding": "VALID", "activation": "NONE"}},
            {"op": "ADD", "inputs": [1, 4] if skip_first else [4, 1],
             "outputs": [5], "options": {"activation": "NONE"}},
            {"op": "PRELU", "inputs": [5, 6], "outputs": [7],
             "options": {}}]}
    np.savez(path, __graph__=json.dumps(meta),
             t2=rng.standard_normal((c, 1, 1, c), dtype=np.float32),
             t3=rng.standard_normal(c, dtype=np.float32),
             t6=rng.standard_normal((1, 1, c), dtype=np.float32))
    return Graph(path)


@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("hwc", [(5, 7, 8), (8, 8, 8)],
                         ids=["oblong", "cube"])
def test_chain_reads_a_skip_in_the_graph_layout(tmp_path, hwc, skip_first):
    graph = _reshape_skip_graph(tmp_path / "g.npz", *hwc, skip_first)
    fused = TFLiteNet(graph).eval()
    plain = TFLiteNet(graph, fuse_epilogues=False).eval()
    assert len(fused.chains) == 1 and fused.chains[0]["skip"] == 1
    assert fused.epilogue_counts == {"CONV_2D": 1, "ADD": 1, "PRELU": 1}
    x = torch.randn(3, *hwc, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        (got,), (want,) = fused(x), plain(x)
    assert got.shape == want.shape == (3, *hwc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _two_conv_add_graph(path, h, w, c):
    """A downsampling unit's tail: x -> CONV_2D 3x3 (a) and x -> CONV_2D
    1x1 stride 1 (b), each read by the ADD alone: ADD(a, b) -> RELU."""
    rng = np.random.default_rng(c)
    act = [1, h, w, c]
    conv = {"stride": [1, 1], "dilation": [1, 1], "activation": "NONE"}
    meta = {
        "inputs": [0], "outputs": [8],
        "tensors": [{"shape": s, "dtype": "float32"} for s in (
            act, [c, 3, 3, c], [c], act, [c, 1, 1, c], [c], act, act,
            act)],
        "ops": [
            {"op": "CONV_2D", "inputs": [0, 1, 2], "outputs": [3],
             "options": dict(conv, padding="SAME")},
            {"op": "CONV_2D", "inputs": [0, 4, 5], "outputs": [6],
             "options": dict(conv, padding="VALID")},
            {"op": "ADD", "inputs": [3, 6], "outputs": [7],
             "options": {"activation": "NONE"}},
            {"op": "RELU", "inputs": [7], "outputs": [8], "options": {}}]}
    np.savez(path, __graph__=json.dumps(meta),
             t1=rng.standard_normal((c, 3, 3, c), dtype=np.float32),
             t2=rng.standard_normal(c, dtype=np.float32),
             t4=rng.standard_normal((c, 1, 1, c), dtype=np.float32),
             t5=rng.standard_normal(c, dtype=np.float32))
    return Graph(path)


def test_an_add_of_two_convs_ends_one_chain(tmp_path):
    graph = _two_conv_add_graph(tmp_path / "g.npz", 6, 5, 8)
    fused = TFLiteNet(graph).eval()
    plain = TFLiteNet(graph, fuse_epilogues=False).eval()
    # the ADD and its RELU go to the chain of the conv later in op order;
    # the other conv runs with its bias and is the chain's skip
    assert len(fused.chains) == 1
    assert fused.chains[0]["conv"] is graph.ops[1]
    assert fused.chains[0]["skip"] == 3
    assert fused.epilogue_counts == {"CONV_2D": 1, "ADD": 1, "RELU": 1}
    x = torch.randn(3, 6, 5, 8, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        (got,), (want,) = fused(x), plain(x)
    assert got.shape == want.shape == (3, 6, 5, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nets,chains,absorbed", [
    (("face_detection_back", "face_landmark", "iris_landmark"), 81, 136),
    (("face_detection_full_range_sparse", "face_landmark", "iris_landmark"),
     123, 142)], ids=["back_f32", "full_sparse_k4_f32"])
def test_benchmark_configurations_chains(nets, chains, absorbed):
    # each configuration's three nets, as PERF.md counts them
    got = [_graph_and_net(n)[1].chains for n in nets]
    assert sum(len(c) for c in got) == chains
    assert sum(len(ch["ops"]) - 1 for c in got for ch in c) == absorbed


def _operands(seed, c=12, cs=8, cl=False):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(2, c, 5, 7, generator=gen)
    skip = torch.randn(2, cs, 5, 7, generator=gen)
    bias = torch.randn(c, generator=gen)
    alpha = torch.randn(1, c, 1, 1, generator=gen)
    if cl:
        y = y.contiguous(memory_format=torch.channels_last)
    return y, skip, bias, alpha


def test_plain_is_the_op_by_op_sequence():
    y, skip, bias, alpha = _operands(0)
    padded = F.pad(skip, (0, 0, 0, 0, 0, 4))
    v = y + bias[:, None, None]
    cases = {
        ("PRELU", False): _prelu(v + padded, alpha),
        ("PRELU", True): _prelu(padded + v, alpha),
        ("RELU", False): torch.relu(v + padded),
        ("RELU6", False): torch.clamp(v + padded, 0.0, 6.0),
        ("NONE", False): v + padded,
    }
    for (act, first), want in cases.items():
        got = ce.conv_epilogue(y, bias, skip,
                               alpha if act == "PRELU" else None, act, first)
        assert torch.equal(got, want), (act, first)
    assert torch.equal(ce.conv_epilogue(y, act="RELU"), torch.relu(y))


def test_output_takes_the_first_operands_layout():
    y, skip, bias, alpha = _operands(1, cs=12, cl=True)
    for first in (False, True):
        got = ce.conv_epilogue(y, bias, skip, alpha, "PRELU", first)
        want = _prelu((skip + (y + bias[:, None, None])) if first
                      else (y + bias[:, None, None]) + skip, alpha)
        assert torch.equal(got, want)
        assert got.stride() == want.stride(), first
        # the fake implementation gives the kernel's output the same
        fake = ce._epilogue_fake(y, bias, skip, alpha, 3, first)
        assert fake.stride() == got.stride()
    assert ce.channels_last(y) and not ce.channels_last(skip)
    # one channel: dense in both layouts, indexed as NCHW
    assert not ce.channels_last(torch.zeros(2, 1, 3, 3).contiguous(
        memory_format=torch.channels_last))


def test_operand_checks():
    y, skip, bias, alpha = _operands(2)
    with pytest.raises(ValueError, match="skip"):
        ce.conv_epilogue(y, skip=torch.zeros(2, 13, 5, 7))
    with pytest.raises(ValueError, match="skip"):
        ce.conv_epilogue(y, skip=skip[:, :, :4])
    with pytest.raises(ValueError, match="neither"):
        ce.conv_epilogue(y[:, :, :, :6])
    with pytest.raises(ValueError, match="alpha"):
        ce.conv_epilogue(y, act="PRELU")
    with pytest.raises(ValueError, match="alpha"):
        ce.conv_epilogue(y, alpha=alpha, act="RELU")
    with pytest.raises(ValueError, match="bias"):
        ce.conv_epilogue(y, bias=bias[:5])
    with pytest.raises(KeyError):
        ce.conv_epilogue(y, act="TANH")
    # an image of 2^31 elements (a view of one value, nothing allocated)
    with pytest.raises(ValueError, match="2\\^31"):
        ce.conv_epilogue(torch.zeros(1, 1, 1, 1).expand(2, 2**15, 2**8,
                                                        2**8))


def test_export_runs_the_operator_through_its_fake():
    graph, net = _graph_and_net("face_landmark")
    x = torch.rand(2, *graph.input_shape[1:])
    with torch.no_grad():
        prog = torch.export.export(net, (x,))
        nodes = [n for n in prog.graph.nodes
                 if n.op == "call_function"
                 and "conv_epilogue" in str(n.target)]
        assert len(nodes) == len(net.chains)
        for got, want in zip(prog.module()(x), net(x)):
            assert torch.equal(got, want)


def test_counters_count_each_net_built():
    graph = Graph(DATA / "iris_landmark.npz")
    nets = (TFLiteNet(graph), TFLiteNet(graph, compute_dtype=torch.bfloat16))
    # the chains, and the ops they absorb: each chain's but its conv
    assert sum(len(net.chains) for net in nets) == 53
    assert sum(sum(net.epilogue_counts.values()) - len(net.chains)
               for net in nets) == 80


def test_abi_test_covers_the_entry_point():
    assert ("conv_epilogue", "conv_epilogue_f32") in ENTRIES
