"""The attention core kernel's host side (``ops.attention_tc``,
``csrc/attention_tc.cu``) and its route in the lowered nets, on the CPU:

* the routing rule (``attention_tc.routes``) case by case: f32, N at most
  144, d a multiple of 8 at most 96, the shared memory of q, k, v and the
  bias and mask tables within a CTA's;
* a routed core computes on the CPU what its ops computed one by one, bit
  for bit: ViT-L's block at the published widths (144 tokens, 8 heads of
  96, no bias) and Swin-S's at stages 1, 2 and 4 (windows of 49, heads of
  32, each head's bias, the shifted windows' mask of 64 and 16 windows an
  image where the block shifts), over several images so that a window's
  place in its image matters; the plain version against an f64 core
  written out in full;
* which cores route (``TFLiteNet.tc_cores``): a small ViT's 2 (none where
  its heads are 12 wide) and the small Swin's 4 (1 masked), a published
  block's 1, ViT-L's 24 and
  Swin-S's 24 (11 masked) in the published graphs; none in a bf16 net,
  in R100 or in any bundled net; a core of another form (a SOFTMAX beta
  other than 1, the scores without ``adj_y``, a bias broadcast over the
  heads) runs op by op;
* a routed core runs once, inside its ``net.attention`` span, and drops
  q, k and v after it;
* the operand checks, the fake implementation under ``torch.export`` and
  the kernel's ABI entry.
The kernel itself is held to an f64 core on the card by
``tests/test_torch_attention_tc_card.py``.
"""

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from test_torch_kernel_abi import ENTRIES
from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.compiler import lowering
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import attention_tc
from tpu_face_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import iresnet  # noqa: E402
from models import swin  # noqa: E402
from models import vit  # noqa: E402

SEED = 2**31 + 26
F32, BF16 = torch.float32, torch.bfloat16

# (n, heads, d, dtype, tables of a bias and a mask) -> routed
RULE = {
    "vit_l": ((144, 8, 96, F32, 0), True),
    "swin_s": ((49, 3, 32, F32, 2), True),
    "one_token": ((1, 1, 8, F32, 2), True),
    "bf16": ((144, 8, 96, BF16, 0), False),
    "n_145": ((145, 8, 96, F32, 0), False),
    "d_100": ((49, 3, 100, F32, 0), False),
    "d_12": ((49, 3, 12, F32, 0), False),
    "d_104": ((49, 3, 104, F32, 0), False),
    "d_4": ((49, 3, 4, F32, 0), False),
    "no_heads": ((49, 0, 32, F32, 0), False),
    # the tables in shared memory beside q, k and v: 250 KB
    "vit_l_biased": ((144, 8, 96, F32, 1), False),
    "n_100_both": ((100, 8, 96, F32, 2), True),
}


@pytest.mark.parametrize("case", RULE)
def test_routing_rule(case):
    args, routed = RULE[case]
    assert attention_tc.routes(*args) is routed


def _view(graph, consts):
    """A graph dict and its constants as ``lowering``'s functions read a
    ``Graph``."""
    return SimpleNamespace(tensors=graph["tensors"], ops=graph["ops"],
                           inputs=graph["inputs"], outputs=graph["outputs"],
                           consts={int(k[1:]): v for k, v in consts.items()})


@pytest.fixture(scope="module")
def swin_weights():
    return swin.draw_weights(SEED, **swin.PUBLISHED)


def _vit_block():
    w = vit.draw_weights(SEED, **vit._sizes(depth=1))
    return _view(*vit.block_graph(w, vit.PUBLISHED["heads"])), [1, 144, 768]


def _swin_block(w, stage, block):
    s = swin.stages(**swin.PUBLISHED)[stage]
    view = _view(*swin.block_graph(w, stage, block, swin.PUBLISHED["input"],
                                   swin.PUBLISHED["window"]))
    return view, [1, s["res"] ** 2, s["dim"]]


def _unrouted(view, monkeypatch):
    """``view``'s net with no core routed: every core op by op."""
    with monkeypatch.context() as m:
        m.setattr(attention_tc, "routes", lambda *args: False)
        net = TFLiteNet(view).eval()
    assert net.tc_cores == {} and net.attention_cores
    return net


# (label, stage, block, masked windows an image or 0); None: ViT-L's block
BLOCKS = [("vit_l", None, None, 0), ("swin_s.1", 0, 0, 0),
          ("swin_s.1_shifted", 0, 1, 64), ("swin_s.2_shifted", 1, 1, 16),
          ("swin_s.4", 3, 1, 0)]


@pytest.mark.parametrize("label,stage,block,windows", BLOCKS)
def test_routed_core_computes_as_its_ops(swin_weights, monkeypatch, label,
                                         stage, block, windows):
    view, shape = (_vit_block() if stage is None
                   else _swin_block(swin_weights, stage, block))
    net = TFLiteNet(view).eval()
    ((first, rec),) = net.tc_cores.items()
    assert (first, rec["last"]) == net.attention_cores[0]
    assert (rec["mask"] is not None) == bool(windows)
    if windows:
        assert net._core_const(rec, "mask").shape == (windows, 49, 49)
    x = torch.randn(3, *shape[1:], generator=torch.Generator().manual_seed(
        5))
    calls = []
    real = attention_tc.attention_tc
    monkeypatch.setattr(attention_tc, "attention_tc",
                        lambda *a: calls.append(a) or real(*a))
    with torch.inference_mode():
        (routed,) = net(x)
        (before,) = _unrouted(view, monkeypatch)(x)
    assert len(calls) == 1 and attention_tc.LAUNCHES == 0
    assert torch.equal(routed, before)


def _f64_core(q, k, v, scale, bias, mask, heads):
    """The core in f64 written out sequence by sequence and head by head."""
    s, n, c = q.shape
    d = c // heads
    out = torch.empty(s, n, c, dtype=torch.float64)
    for i in range(s):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            x = q[i, :, cols].double() @ k[i, :, cols].double().T
            x = x * float(scale)
            if bias is not None:
                x = x + bias[h].double()
            if mask is not None:
                x = x + mask[i % mask.shape[0]].double()
            out[i, :, cols] = torch.softmax(x, -1) @ v[i, :, cols].double()
    return out


@pytest.mark.parametrize("n,heads,d,windows,images", [
    (144, 2, 96, 0, 2), (49, 3, 32, 4, 3), (49, 2, 32, 0, 5),
    (9, 2, 8, 2, 2)])
def test_plain_version_is_the_core(n, heads, d, windows, images):
    gen = torch.Generator().manual_seed(n + heads)
    seqs = images * max(windows, 1)
    q, k, v = (torch.randn(seqs, n, heads * d, generator=gen)
               for _ in range(3))
    scale = torch.tensor(d ** -0.5)
    bias = torch.randn(heads, n, n, generator=gen) if windows else None
    mask = (torch.where(torch.rand(windows, n, n, generator=gen) < 0.3,
                        -100.0, 0.0) if windows else None)
    got = attention_tc.attention_tc(q, k, v, scale, bias, mask, heads)
    want = _f64_core(q, k, v, scale, bias, mask, heads)
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-5)


def _routed_cores(view, dtype=F32):
    """[(first, last, masked)] of the cores of ``view`` that route."""
    spans, _ = lowering._mechanism_spans(view.ops, view.consts,
                                         view.tensors, set(view.outputs))
    out = []
    for a, (name, b) in sorted(spans.items()):
        rec = name == lowering.ATTENTION and lowering._attention_operands(
            view.ops[a:b + 1], view.consts, view.tensors, dtype)
        if rec:
            out.append((a, b, rec["mask"] is not None))
    return out


def test_published_graphs_route_every_core(swin_weights):
    w = vit.draw_weights(SEED, **vit.PUBLISHED)
    view = _view(*vit.graph_from_weights(w, vit.PUBLISHED["heads"],
                                         vit.PUBLISHED["input"]))
    del w
    cores = _routed_cores(view)
    assert len(cores) == 24 and not any(m for _, _, m in cores)
    assert _routed_cores(view, BF16) == []
    view = _view(*swin.graph_from_weights(
        swin_weights, swin.PUBLISHED["input"], swin.PUBLISHED["window"]))
    cores = _routed_cores(view)
    assert len(cores) == 24 and sum(m for _, _, m in cores) == 11


@pytest.mark.parametrize("model,sizes,counts", [
    (vit, {"depth": 2, "dim": 128, "heads": 8, "mlp": 256, "embedding": 64},
     (2, 0)),
    # heads of 12: no multiple of 8, every core op by op
    (vit, {"depth": 2, "dim": 96, "heads": 8, "mlp": 384, "embedding": 64},
     (0, 0)),
    (swin, {"input": 56, "depths": (2, 2), "dim": 32, "heads": (1, 2),
            "embedding": 64}, (4, 1))])
def test_small_nets_record_their_cores(tmp_path, model, sizes, counts):
    made = model.write(tmp_path, SEED, files=(model.GRAPH_FILE,), **sizes)
    graph = Graph(made / model.GRAPH_FILE)
    net = TFLiteNet(graph)
    assert len(net.attention_cores) == (
        sizes["depth"] if model is vit else sum(sizes["depths"]))
    assert set(net.tc_cores) <= {a for a, _ in net.attention_cores}
    masked = [a for a, rec in net.tc_cores.items() if rec["mask"] is not None]
    assert (len(net.tc_cores), len(masked)) == counts
    assert masked == [a for a, _ in net.masked_cores]
    assert TFLiteNet(graph, compute_dtype=BF16).tc_cores == {}


def test_r100_routes_no_core(tmp_path):
    made = iresnet.write(tmp_path, SEED, [1, 1, 1, 1], [8, 16, 32, 64], 64,
                         112, files=(iresnet.GRAPH_FILE,))
    assert TFLiteNet(Graph(made / iresnet.GRAPH_FILE)).tc_cores == {}


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        Path(_DATA_DIR).glob("*.npz")))
def test_bundled_nets_route_no_core(name):
    assert TFLiteNet(Graph(Path(_DATA_DIR) / f"{name}.npz")).tc_cores == {}


def _edit(view, name, fn):
    """``view`` with ``fn`` applied to a copy of the op whose output tensor
    is named ``name``."""
    ops = copy.deepcopy(view.ops)
    consts = dict(view.consts)
    (node,) = [n for n in ops
               if view.tensors[n["outputs"][0]]["name"].endswith(name)]
    fn(node, consts)
    return SimpleNamespace(ops=ops, consts=consts, tensors=view.tensors,
                           inputs=view.inputs, outputs=view.outputs)


def _broadcast_bias(node, consts):
    c = next(i for i in node["inputs"] if i in consts)
    consts[c] = consts[c][:1]


@pytest.mark.parametrize("name,fn", [
    ("attn/softmax", lambda n, c: n["options"].update(beta=0.5)),
    ("attn/scores", lambda n, c: n["options"].update(adj_y=False)),
    ("attn/biased", _broadcast_bias)])
def test_cores_of_another_form_run_op_by_op(swin_weights, name, fn):
    view, _ = _swin_block(swin_weights, 0, 1)
    assert len(_routed_cores(view)) == 1
    edited = _edit(view, name, fn)
    spans, _ = lowering._mechanism_spans(
        edited.ops, edited.consts, edited.tensors, set(edited.outputs))
    assert [n for n, _ in spans.values()].count(lowering.ATTENTION) == 1
    assert _routed_cores(edited) == []


def test_core_runs_in_its_span_and_frees_its_operands(monkeypatch):
    view, _ = _vit_block()
    net = TFLiteNet(view).eval()
    ((first, rec),) = net.tc_cores.items()
    # q, k and v dead by the core's last op, its ops computed at its first
    dead = {t for at, ts in net._dead_after.items()
            if first <= at <= rec["last"] for t in ts}
    assert {rec["q"], rec["k"], rec["v"]} <= dead
    assert net._executed_at({id(n): i for i, n in enumerate(view.ops)})[
        rec["last"]] == first
    open_spans, seen = [], []

    class Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            open_spans.append(self.name)

        def __exit__(self, *exc):
            open_spans.pop()

    real = attention_tc.attention_tc
    monkeypatch.setattr(profiling, "stage", Span)
    monkeypatch.setattr(attention_tc, "attention_tc", lambda *a: seen.append(
        list(open_spans)) or real(*a))
    x = torch.randn(2, 144, 768, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        net(x)
    assert seen == [[lowering.ATTENTION]]


def test_operand_checks():
    q = torch.randn(4, 9, 16)
    scale = torch.tensor(0.25)
    with pytest.raises(ValueError, match="q must be f32"):
        attention_tc.attention_tc(q.double(), q, q, heads=2)
    with pytest.raises(ValueError, match="k must be"):
        attention_tc.attention_tc(q, q[:, :8], q, heads=2)
    with pytest.raises(ValueError, match="v must be"):
        attention_tc.attention_tc(q, q, q.double(), heads=2)
    with pytest.raises(ValueError, match="heads"):
        attention_tc.attention_tc(q, q, q, heads=3)
    with pytest.raises(ValueError, match="scale"):
        attention_tc.attention_tc(q, q, q, torch.ones(2), heads=2)
    with pytest.raises(ValueError, match="bias"):
        attention_tc.attention_tc(q, q, q, scale, torch.ones(9, 9), heads=2)
    for bad in (torch.ones(3, 9, 9), torch.ones(2, 9, 8),
                torch.ones(2, 9, 9).double()):
        with pytest.raises(ValueError, match="mask"):
            attention_tc.attention_tc(q, q, q, scale, None, bad, heads=2)


def test_export_gives_the_shape():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 49, 64, generator=gen) for _ in range(3))

    class Core(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("scale", torch.tensor(0.125))
            self.register_buffer("bias", torch.randn(2, 49, 49,
                                                     generator=gen))
            self.register_buffer("mask", torch.randn(2, 49, 49,
                                                     generator=gen))

        def forward(self, q, k, v):
            return attention_tc.attention_tc(q, k, v, self.scale, self.bias,
                                             self.mask, 2)

    core = Core()
    with torch.no_grad():
        prog = torch.export.export(core, (q, k, v))
    nodes = [n for n in prog.graph.nodes if n.op == "call_function"
             and "attention_tc" in str(n.target)]
    assert len(nodes) == 1
    assert tuple(nodes[0].meta["val"].shape) == (4, 49, 64)
    assert torch.equal(prog.module()(q, k, v), core(q, k, v))


def test_abi_test_covers_the_entry_point():
    assert ("attention_tc", "attention_tc_f32") in ENTRIES
