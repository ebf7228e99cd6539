"""The bf16 fused residual-block kernel's host side on the CPU
(tpu_face_torch/ops/fused_block.py, csrc/fused_dw_pw_block_bf16.cu).

The kernel cannot run here (no card, no nvcc); chip_smoke.py holds it
against ``fused_blocks_plain`` on the card within one bf16 unit in the
last place of max|plain|.
Here:

* ``plan`` with 2-byte activations fits the kernel's own shared-memory
  formula (``smem_bytes_bf16``) at the BACK detector's four runs, the
  FRONT/SHORT runs and the Pallas K4 prototype's shape;
* ``pack_bf16`` (the kernel's weight blob) unpacks to the stacked
  weights as the plain version rounds them, exactly;
* ``TFLiteNet`` keeps each run's kernel weights and tiling, made once:
  they equal ``kernel_weights`` and a fresh ``plan``, and a bf16 net that
  passes them gives the CPU output of the plain version on the raw
  weights, bit for bit;
* the plain bf16 version still matches ``xla_blocks`` of
  docs/experiments/fused_block_v2.py:59-71 (restated, as
  tests/test_torch_fused_block.py does) within 2e-2 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.compiler import Graph, TFLiteNet
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import fused_block

BF16 = torch.bfloat16
DETECTORS = ("face_detection_back", "face_detection_front",
             "face_detection_short_range")
# (C, H, W, layers): the BACK runs, the FRONT/SHORT runs, the K4
# prototype (docs/experiments/fused_block_v2.py: 128x128x24, 7 blocks)
SHAPES = {"back_r1": (24, 128, 128, 7), "back_r2": (24, 64, 64, 7),
          "back_r3": (48, 32, 32, 7), "back_r4": (96, 16, 16, 7),
          "front_r1": (24, 64, 64, 1), "front_r2": (96, 8, 8, 4),
          "k4_prototype": (24, 128, 128, 7)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bf16_plan_fits_the_kernels_shared_memory(name):
    c, h, w, layers = SHAPES[name]
    tile, chunks = fused_block.plan(c, h, w, layers, 2)
    assert sum(chunks) == layers and min(chunks) >= 1
    assert chunks == fused_block.split_layers(layers, chunks[0])
    assert tile % 2 == 0 and 2 <= tile <= max(h, w) + 1
    assert fused_block.smem_bytes_bf16(c, tile, max(chunks), h, w) <= \
        fused_block.SMEM_LIMIT
    assert fused_block.plan(c, h, w, layers, 2) == (tile, chunks)
    # its pick is the least modelled time of every tiling that fits
    best = fused_block.bf16_cost(c, h, w, tile, chunks)
    for per in range(1, layers + 1):
        for t in range(2, max(h, w) + 2, 2):
            if fused_block.smem_bytes_bf16(c, t, per, h, w) <= \
                    fused_block.SMEM_LIMIT:
                assert best <= fused_block.bf16_cost(
                    c, h, w, t, fused_block.split_layers(layers, per))


@pytest.mark.parametrize("tile,layers,ctas", [(16, 4, 2), (22, 4, 2),
                                              (36, 4, 1)])
def test_bf16_cost_charges_a_lone_cta(tile, layers, ctas):
    """A tiling whose shared memory leaves one CTA per SM is modelled at
    half the rate of one that leaves two."""
    c, h, w = 24, 128, 128
    assert fused_block.bf16_ctas_per_sm(c, tile, layers, h, w) == ctas
    cost = fused_block.bf16_cost(c, h, w, tile, (layers,))
    fused_block.BF16_CTAS_PER_SM, keep = 1, fused_block.BF16_CTAS_PER_SM
    try:
        lone = fused_block.bf16_cost(c, h, w, tile, (layers,))
    finally:
        fused_block.BF16_CTAS_PER_SM = keep
    assert lone == pytest.approx(cost * ctas)


def _weights(c, layers=3, seed=0):
    g = torch.Generator().manual_seed(seed + c)
    return (torch.randn(layers, c, 3, 3, generator=g),
            torch.randn(layers, c, generator=g),
            torch.randn(layers, c, c, generator=g),
            torch.randn(layers, c, generator=g))


@pytest.mark.parametrize("layers", [1, 3, 7])
@pytest.mark.parametrize("c", fused_block.CHANNELS)
def test_packed_weights_unpack_to_the_stacked_ones(c, layers):
    wd, bd, wp, bp = _weights(c, layers)
    packed = fused_block.pack_bf16(wd, bd, wp, bp)
    assert packed.dtype == torch.uint8
    assert tuple(packed.shape) == (layers, fused_block.blob_bytes(c))
    assert fused_block.blob_bytes(c) % 16 == 0      # 16-byte cp.async
    for got, want in zip(fused_block.unpack_bf16(packed, c),
                         (wd, bd, wp, bp)):
        assert torch.equal(got, want.to(BF16).float())
    # the 1x1's padding columns are zero
    stride = fused_block.weight_stride(c)
    wpp = packed[:, :2 * c * stride].contiguous().view(BF16).reshape(
        layers, c, stride)
    assert not wpp[:, :, c:].any()
    # the kernel's form of bf16 weights is the same blob
    (same,) = fused_block.kernel_weights(*(t.to(BF16) for t in
                                           (wd, bd, wp, bp)), BF16)
    assert torch.equal(same, packed)


def test_f32_kernel_weights_are_the_transposed_1x1():
    """The f32 kernel's blob per layer (``pack_f32``): the 1x1 transposed
    to [C_in][C + 4] (zero padding columns), the taps as [9][C], then bd
    and bp, all f32 as given."""
    c, layers = 24, 3
    wd, bd, wp, bp = _weights(c, layers)
    (got,) = fused_block.kernel_weights(wd, bd, wp, bp, torch.float32)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert tuple(got.shape) == (layers, fused_block.blob_floats(c))
    assert fused_block.blob_floats(c) % 4 == 0      # 16-byte cp.async
    n = c * (c + 4)
    wpt = got[:, :n].reshape(layers, c, c + 4)
    assert torch.equal(wpt[:, :, :c], wp.transpose(1, 2))
    assert not wpt[:, :, c:].any()
    taps = got[:, n:n + 9 * c].reshape(layers, 9, c)
    assert torch.equal(taps.transpose(1, 2).reshape(layers, c, 3, 3), wd)
    assert torch.equal(got[:, n + 9 * c:n + 10 * c], bd)
    assert torch.equal(got[:, n + 10 * c:], bp)


@pytest.fixture(scope="module")
def graphs():
    return {n: Graph(_DATA_DIR / f"{n}.npz") for n in DETECTORS}


NETS = [(n, d) for n in DETECTORS for d in ("f32", "bf16")]
DTYPES = {"f32": torch.float32, "bf16": BF16}


@pytest.mark.parametrize("name,dtype", NETS)
def test_cached_tiling_equals_a_fresh_plan(graphs, name, dtype):
    net = TFLiteNet(graphs[name], compute_dtype=DTYPES[dtype])
    itemsize = 2 if dtype == "bf16" else 4
    assert net.run_tilings == [fused_block.plan(c, h, w, n, itemsize)
                               for c, h, w, n in net.run_shapes]
    assert net.fused_launches() == sum(len(chunks)
                                       for _, chunks in net.run_tilings)


@pytest.mark.parametrize("name,dtype", NETS)
def test_cached_weights_are_the_kernels_form(graphs, name, dtype):
    net = TFLiteNet(graphs[name], compute_dtype=DTYPES[dtype])
    for k in range(len(net.runs)):
        stacked = [getattr(net, f"run{k}_{n}") for n in ("wd", "bd", "wp",
                                                         "bp")]
        want = fused_block.kernel_weights(*stacked, DTYPES[dtype])
        got = [getattr(net, f"run{k}_kernel{i}") for i in range(len(want))]
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", DETECTORS)
def test_bf16_net_with_cached_weights_gives_the_plain_output(graphs, name):
    """Each run reaches ``fused_blocks`` with the net's cached tiling and
    kernel weights (the same objects every call), and the net's CPU
    output equals the plain version's on the raw stacked weights, bit
    for bit."""
    net = TFLiteNet(graphs[name], compute_dtype=BF16).eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1.0, 1.0, (2,) + tuple(graphs[name].input_shape[1:])).astype(
            np.float32))
    real = fused_block.fused_blocks
    seen = []

    def cached(x_, *w, tiling=None, weights=None):
        seen.append((tiling, weights))
        return real(x_, *w, tiling=tiling, weights=weights)

    def plain(x_, *w, tiling=None, weights=None):
        return fused_block.fused_blocks_plain(x_, *w)

    outs = {}
    for label, fn in (("cached", cached), ("plain", plain)):
        fused_block.fused_blocks = fn
        try:
            with torch.inference_mode():
                outs[label] = net(x)
        finally:
            fused_block.fused_blocks = real
    for g, w in zip(outs["cached"], outs["plain"]):
        assert torch.equal(g, w)
    assert len(seen) == len(net.runs)
    for k, (tiling, weights) in enumerate(seen):
        assert tiling == net.run_tilings[k]
        assert weights[0] is getattr(net, f"run{k}_kernel0")


def _xla_blocks_bf16(x, wd, wp, bias):
    """fused_block_v2.py:59-71: per layer a SAME depthwise 3x3 without
    bias, a 1x1 plus one bias, the residual add and the relu, every op's
    output in bf16 (x NHWC, wd [L, 3, 3, C], wp [L, C_out, C_in])."""
    c = x.shape[-1]
    dt = jnp.bfloat16
    x = jnp.asarray(x).astype(dt)
    for k in range(wd.shape[0]):
        y = lax.conv_general_dilated(
            x, jnp.asarray(wd[k]).reshape(3, 3, 1, c).astype(dt), (1, 1),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c, preferred_element_type=dt)
        y = lax.conv_general_dilated(
            y, jnp.asarray(wp[k]).T.reshape(1, 1, c, c).astype(dt), (1, 1),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=dt) + jnp.asarray(bias[k]).astype(dt)
        x = jnp.maximum(y + x, 0.0)
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("c,layers", [(8, 3), (24, 2), (48, 1)])
def test_plain_bf16_matches_v2_reference(c, layers):
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, 12, 10, c)).astype(np.float32)
    wd = (rng.normal(size=(layers, 3, 3, c)) * 0.2).astype(np.float32)
    wp = (rng.normal(size=(layers, c, c)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(layers, c)).astype(np.float32)
    want = _xla_blocks_bf16(x, wd, wp, bias)
    got = fused_block.fused_blocks_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16),
        torch.from_numpy(wd).permute(0, 3, 1, 2), torch.zeros(layers, c),
        torch.from_numpy(wp), torch.from_numpy(bias))
    assert got.dtype == BF16
    err = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
