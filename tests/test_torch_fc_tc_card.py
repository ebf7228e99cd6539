"""The split-TF32 token FC kernel (``csrc/fc_tc.cu``) on a CUDA card (each
test skips without one; run on the card with ``python -m pytest
tests/test_torch_fc_tc_card.py -q``).

* At ViT-L's three FC shapes (K, N) and 1, 3 and 128 crops of 144 tokens
  (``SHAPES``, ``ROWS``), and at two of Swin-S's at 128 crops
  (``SWIN_SHAPES``: K = 96, and N = 192 on the 256x64 tile), against an
  f64 product: its largest error, over the largest magnitude of the f64
  output, is at most ``ERR_RATIO`` times cuBLAS's f32 product's (TF32
  off); the kernel with TF32 allowed (one product a step) fails that same
  bound.
* Tiles and ragged rows: on small-integer operands, whose products and
  sums f32 holds exactly, with an integer bias and each activation, it
  equals the f64 result bit for bit at N tiles of 64 and 128, one and
  ragged last M tiles.
* The epilogue: the kernel's bias and activation equal its bare product
  followed by ATen's ``+ bias`` and ``relu`` or ``clamp(0, 6)``, bit for
  bit, at ViT-L's fc1 shape with pre-activations that ReLU6 clips.
* With ``torch.backends.cuda.matmul.allow_tf32`` set it takes one
  product: its result is the f64 product of the TF32-rounded operands to
  f32's rounding, far from the exact one.
* Launches: a forward of a ViT block at the published widths adds 6 to
  ``LAUNCHES`` (q, k, v, proj, fc1, fc2), R100's EmbedCascade call none.
* Captured in a CUDA graph, its replay equals the eager call, alone and
  in the ViT block.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import exact_f32
from tpu_face_torch.compiler.lowering import TFLiteNet
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.ops import fc_tc, wgmma_tf32
from tpu_face_torch.pipeline import EmbedCascade

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import iresnet  # noqa: E402
from models import vit as gen  # noqa: E402

SEED = 2**31 + 24
TOKENS = 144
# (K, N) of ViT-L's token FCs: q, k, v and proj; fc1; fc2
SHAPES = [(768, 768), (768, 3072), (3072, 768)]
ROWS = [TOKENS, 3 * TOKENS, 128 * TOKENS]
# (M, K, N) of Swin-S's token FCs at 128 crops: stage 1's fc1 (3,136
# tokens a crop), and stage 2's q, k, v, proj and fc2 (784)
SWIN_SHAPES = [(128 * 3136, 96, 384), (128 * 784, 192, 192)]
# the kernel's error against cuBLAS's f32 one: split TF32 drops a_lo*b_lo
# (~2^-22 of a product) and the tensor cores sum each k8 step in their
# own order, so its error is of f32's size, not TF32's (~2^-11, ~1000x)
ERR_RATIO = 4.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with exact_f32():
        yield torch.device("cuda", 0)


def _operands(m, k, n, device, seed):
    gen_ = torch.Generator(device).manual_seed(seed)
    x = torch.randn(m, k, device=device, generator=gen_)
    w = torch.randn(n, k, device=device, generator=gen_) / k ** 0.5
    return x, w


def _rel_err(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_error_within_cublas_f32(card, k, n, m):
    _check_error(card, m, k, n)


@pytest.mark.parametrize("m,k,n", SWIN_SHAPES)
def test_error_within_cublas_f32_swin(card, m, k, n):
    _check_error(card, m, k, n)


def _check_error(card, m, k, n):
    x, w = _operands(m, k, n, card, m + k + n)
    hi, lo = fc_tc.kernel_weights(w)
    with torch.inference_mode():
        want = x.double() @ w.double().t()
        got = fc_tc.fc_tc(x, w, hi, lo)
        cublas = x @ w.t()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fc_tc.fc_tc(x, w, hi, lo)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    errs = {name: _rel_err(y, want) for name, y in
            (("kernel", got), ("cublas_f32", cublas), ("tf32", tf32))}
    bound = ERR_RATIO * errs["cublas_f32"]
    assert errs["kernel"] <= bound, errs
    assert errs["tf32"] > bound, errs


@pytest.mark.parametrize("m,k,n", [(1, 32, 64), (77, 96, 192),
                                   (300, 768, 128), (1000, 3072, 64)])
def test_exact_on_integers_tiles_and_ragged_rows(card, m, k, n):
    gen_ = torch.Generator(card).manual_seed(m + k)
    x = torch.randint(-4, 5, (m, k), device=card, generator=gen_).float()
    w = torch.randint(-4, 5, (n, k), device=card, generator=gen_).float()
    bias = torch.randint(-40, 41, (n,), device=card, generator=gen_).float()
    hi, lo = fc_tc.kernel_weights(w)
    assert not lo.any()
    exact = x.double() @ w.double().t()
    for act, fn in (("NONE", lambda v: v), ("RELU", torch.relu),
                    ("RELU6", lambda v: torch.clamp(v, 0, 6))):
        for b in (None, bias):
            with torch.inference_mode():
                got = fc_tc.fc_tc(x, w, hi, lo, b, act)
            want = fn(exact if b is None else exact + b.double())
            assert torch.equal(got.double(), want), (act, b is None)


@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
def test_epilogue_equals_aten_after_the_bare_product(card, act):
    # fc1 at 16 crops: pre-activations of standard deviation ~2, so
    # ReLU6 clips at both ends
    x, w = _operands(16 * TOKENS, 768, 3072, card, 7)
    w = 2 * w
    bias = torch.randn(3072, device=card,
                       generator=torch.Generator(card).manual_seed(8))
    hi, lo = fc_tc.kernel_weights(w)
    with torch.inference_mode():
        got = fc_tc.fc_tc(x, w, hi, lo, bias, act)
        bare = fc_tc.fc_tc(x, w, hi, lo)
        want = bare + bias
        if act == "RELU":
            want = torch.relu(want)
        elif act == "RELU6":
            want = torch.clamp(want, 0.0, 6.0)
    torch.cuda.synchronize()
    if act == "RELU6":
        assert bool((want == 6).any()) and bool((want == 0).any())
    assert torch.equal(got, want), float((got - want).abs().max())


def test_tf32_allowed_takes_one_product(card):
    x, w = _operands(3 * TOKENS, 768, 768, card, 9)
    hi, lo = fc_tc.kernel_weights(w)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = fc_tc.fc_tc(x, w, hi, lo)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    one = (wgmma_tf32.round_tf32(x).double()
           @ wgmma_tf32.round_tf32(w).double().t())
    exact = x.double() @ w.double().t()
    # the TF32 product to f32's summation error; TF32's ~2^-11 off the
    # exact one
    assert _rel_err(got, one) < 1e-5 < _rel_err(got, exact)


def _block_net(device):
    """One ViT block at the published widths as a net (6 routed FCs)."""
    w = gen.draw_weights(SEED, **gen._sizes(depth=1))
    graph, consts = gen.block_graph(w, gen.PUBLISHED["heads"])
    view = SimpleNamespace(
        tensors=graph["tensors"], ops=graph["ops"], inputs=graph["inputs"],
        outputs=graph["outputs"],
        consts={int(k[1:]): v for k, v in consts.items()})
    return TFLiteNet(view).to(device).eval()


def test_launches_a_routed_fc_each(card, tmp_path):
    net = _block_net(card)
    assert len(net.tc_fcs) == 6
    x = torch.randn(4, TOKENS, 768, device=card,
                    generator=torch.Generator(card).manual_seed(10))
    before = fc_tc.LAUNCHES
    with torch.inference_mode():
        net(x)
    torch.cuda.synchronize()
    assert fc_tc.LAUNCHES - before == 6
    # R100's one FC (a row a sample) stays on torch.matmul
    made = iresnet.write(tmp_path, SEED, files=(iresnet.GRAPH_FILE,))
    embed = EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                         embed_model_path=str(made), max_faces=4,
                         device=card)
    assert embed._embed_net.tc_fcs == {}
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 360, 640, 3), dtype=np.uint8)).to(card)
    before = fc_tc.LAUNCHES
    with torch.inference_mode():
        embed._forward(frames, (640, 360))
    torch.cuda.synchronize()
    assert fc_tc.LAUNCHES == before


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
    for t in out if isinstance(out, tuple) else (out,):
        t.zero_()
    graph.replay()
    return out


def test_graph_replay_equals_eager(card):
    x, w = _operands(5 * TOKENS, 768, 3072, card, 11)
    hi, lo = fc_tc.kernel_weights(w)
    bias = torch.randn(3072, device=card)
    with torch.inference_mode():
        eager = fc_tc.fc_tc(x, w, hi, lo, bias, "RELU6")
        out = _replay(lambda: fc_tc.fc_tc(x, w, hi, lo, bias, "RELU6"))
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    net = _block_net(card)
    x = torch.randn(8, TOKENS, 768, device=card,
                    generator=torch.Generator(card).manual_seed(12))
    with torch.inference_mode():
        eager = net(x)
        out = _replay(lambda: net(x))
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0])
