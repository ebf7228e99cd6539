"""The attention core kernel (``csrc/attention_tc.cu``) on a CUDA card (each
test skips without one; run on the card with ``python -m pytest
tests/test_torch_attention_tc_card.py -q``).

* At ViT-L's core (144 tokens, 8 heads of 96) and at Swin-S's four stages'
  (windows of 49 tokens, 3 to 24 heads of 32, each head's bias, the
  shifted windows' mask of 64, 16 and 4 windows an image in the first
  three), over several sequences and images, against the plain version
  in f64: its largest error, over the largest magnitude of the f64
  output, is at most ``ERR_RATIO`` times that of the plain version on the
  card in f32 (ATen's ops, cuBLAS with TF32 off); the kernel with TF32
  allowed (one product for each of the split's three) fails that same
  bound.
* With ``torch.backends.cuda.matmul.allow_tf32`` set it takes one product:
  its mean error from the f64 core of TF32-rounded q, k, v and p is a
  tenth of that from the exact core at most.
* Captured in a CUDA graph, its replay equals the eager call.
* Launches: a forward of ViT-L and of Swin-S at their published widths
  adds 24 to ``LAUNCHES`` each, one a core.
"""

import sys
from pathlib import Path

import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import exact_f32
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.ops import attention_tc, wgmma_tf32

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import swin  # noqa: E402
from models import vit  # noqa: E402

SEED = 2**31 + 26
# (label, sequences, tokens, heads, d, windows an image or 0 (no mask),
#  bias): ViT-L's core at 16 crops; Swin-S's stages at 2 images (the
#  masks' windows at 56, 28 and 14 tokens a side; stage 4's one window
#  unshifted)
SHAPES = [("vit_l", 16, 144, 8, 96, 0, False),
          ("swin_s.1", 2 * 64, 49, 3, 32, 64, True),
          ("swin_s.2", 2 * 16, 49, 6, 32, 16, True),
          ("swin_s.3", 2 * 4, 49, 12, 32, 4, True),
          ("swin_s.4", 2, 49, 24, 32, 0, True)]
# the kernel's error against ATen's f32 core: split TF32 drops a_lo*b_lo
# (~2^-22 of a product), the tensor cores sum each k8 step in their own
# order and the sums' orders differ, so its error is of f32's size, not
# TF32's (~2^-11, ~1000x)
ERR_RATIO = 4.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with exact_f32():
        yield torch.device("cuda", 0)


def _operands(seqs, n, heads, d, windows, bias, device):
    """q, k, v [seqs, n, heads * d] normal, logits of standard deviation
    ~2; the scale 1 / sqrt(d); the bias normal and the mask Swin's -100
    regions (swin.region_mask at the windows' grid)."""
    gen = torch.Generator(device).manual_seed(seqs * n + heads)
    q, k, v = (torch.randn(seqs, n, heads * d, device=device, generator=gen)
               for _ in range(3))
    q = 2 * q
    scale = torch.tensor(d ** -0.5, device=device)
    b = (torch.randn(heads, n, n, device=device, generator=gen)
         if bias else None)
    mask = None
    if windows:
        side = 7 * int(windows ** 0.5)
        mask = torch.from_numpy(swin.region_mask(side, 7, 3)).to(device)
        assert tuple(mask.shape) == (windows, n, n)
    return q, k, v, scale, b, mask


def _rel_err(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


def _mean_err(y, want):
    return float((y.double() - want).abs().mean() / want.abs().max())


def _core(*operands, heads, tf32=False):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            return attention_tc.attention_tc(*operands, heads=heads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("label,seqs,n,heads,d,windows,bias", SHAPES)
def test_error_within_aten_f32(card, label, seqs, n, heads, d, windows,
                               bias):
    ops = _operands(seqs, n, heads, d, windows, bias, card)
    with torch.inference_mode():
        want = attention_tc.attention_tc_plain(
            *(None if t is None else t.double() for t in ops), heads)
        aten = attention_tc.attention_tc_plain(*ops, heads)
    before = attention_tc.LAUNCHES
    got = _core(*ops, heads=heads)
    tf32 = _core(*ops, heads=heads, tf32=True)
    torch.cuda.synchronize()
    assert attention_tc.LAUNCHES - before == 2
    errs = {name: _rel_err(y, want) for name, y in
            (("kernel", got), ("aten_f32", aten), ("tf32", tf32))}
    bound = ERR_RATIO * errs["aten_f32"]
    assert errs["kernel"] <= bound, (label, errs)
    assert errs["tf32"] > bound, (label, errs)


@pytest.mark.parametrize("label,seqs,n,heads,d,windows,bias",
                         [SHAPES[0], SHAPES[1]])
def test_tf32_allowed_takes_one_product(card, label, seqs, n, heads, d,
                                        windows, bias):
    q, k, v, scale, b, mask = _operands(seqs, n, heads, d, windows, bias,
                                        card)
    got = _core(q, k, v, scale, b, mask, heads=heads, tf32=True)
    rounded = [wgmma_tf32.round_tf32(t) for t in (q, k, v)]
    # the one-product core: TF32 q, k and v, p rounded to f32, then TF32
    s, n_, c = q.shape
    split = [t.double().reshape(s, n_, heads, -1).permute(0, 2, 1, 3)
             for t in rounded]
    x = split[0] @ split[1].transpose(-1, -2) * scale.double()
    if b is not None:
        x = x + b.double()
    if mask is not None:
        x = (x.reshape(-1, mask.shape[0], heads, n_, n_)
             + mask[:, None].double()).reshape(s, heads, n_, n_)
    p = wgmma_tf32.round_tf32(torch.softmax(x, -1).float()).double()
    one = (p @ split[2]).permute(0, 2, 1, 3).reshape(s, n_, c)
    with torch.inference_mode():
        exact = attention_tc.attention_tc_plain(
            *(None if t is None else t.double()
              for t in (q, k, v, scale, b, mask)), heads)
    # p's TF32 rounding flips where p in f32 lies next to a rounding
    # boundary, and a flip moves an output by ~2^-11 of a term: the mean
    # error, not the largest, tells one product from the exact core
    assert _mean_err(got, one) < 0.1 * _mean_err(got, exact), label


def _replay(fn):
    """fn's result from a CUDA graph's replay, captured after a warm-up
    on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    return out


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
def test_graph_replay_equals_eager(card, shape):
    _, seqs, n, heads, d, windows, bias = shape
    ops = _operands(seqs, n, heads, d, windows, bias, card)
    with torch.inference_mode():
        eager = attention_tc.attention_tc(*ops, heads=heads)
        out = _replay(lambda: attention_tc.attention_tc(*ops, heads=heads))
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("model,crops,side", [(vit, 2, 112),
                                              (swin, 2, 224)])
def test_a_forward_launches_one_a_core(card, tmp_path, model, crops, side):
    made = model.write(tmp_path, SEED, files=(model.GRAPH_FILE,))
    net = TFLiteNet(Graph(made / model.GRAPH_FILE)).to(card).eval()
    masked = sum(rec["mask"] is not None for rec in net.tc_cores.values())
    assert (len(net.tc_cores), masked) == (
        (24, 11) if model is swin else (24, 0))
    x = torch.rand(crops, side, side, 3, device=card,
                   generator=torch.Generator(card).manual_seed(3))
    before = attention_tc.LAUNCHES
    with torch.inference_mode():
        net(x)
    torch.cuda.synchronize()
    assert attention_tc.LAUNCHES - before == 24
