"""What the split-TF32 tensor-core kernels' wrappers share (``conv_tc``
for ``csrc/conv3x3_tc.cu``, ``fc_tc`` for ``csrc/fc_tc.cu``; the CUDA
side shares ``csrc/wgmma_tf32.cuh``): the TF32 split of an f32 value, the
tile order both kernels read their weights' hi and lo parts in, their
tiles and the plan of a launch.

Both kernels compute an [M, N] product over K in 32-wide K steps
(``BK``) with the B operand K-major: an M tile of ``TILES[bn]`` rows by
an N tile of ``bn`` columns, summing a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in
f32, the A operand split as it is loaded and B split once into hi and lo
(``tiles``).
"""

import functools

import torch

BK = 32                # K a stage: a 128-byte row of 32 floats (kBK)
# the kernels' tiles, {N tile: M tile}: the same work and the same bytes
# a stage, so the wide one, which never takes more tiles, is taken
# wherever it divides N
TILES = {128: 128, 64: 256}
_TF32_DROP = 0x1FFF    # the 13 low mantissa bits TF32 does not keep


def round_tf32(t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the card's ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (_TF32_DROP + 1) // 2) & ~_TF32_DROP).view(torch.float32)


def split_tf32(t):
    """(hi, lo), TF32 values with ``hi + lo`` within 2^-22 of f32 ``t``:
    hi = tf32(t), lo = tf32(t - hi)."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


def tiles(w):
    """The hi and lo parts of a K-major operand ``w`` [N, K] (K a multiple
    of 32) in the kernels' tile order, each [K / 32, N, 32]: for K step k
    and row n, 32 floats, a 128-byte row of the kernel's B tile as shared
    memory holds it under the 128B swizzle (16-byte chunk c at c ^ (n %
    8)), in the kernels' K order within the step (float 4c + d of the row
    is column 32k + 8d + (c ^ (n % 8)) of w)."""
    n, k = w.shape
    steps = w.reshape(n, k // BK, BK).permute(1, 0, 2)
    rows = torch.arange(n)[:, None]
    slot = torch.arange(BK)[None, :]
    column = 8 * (slot % 4) + ((slot // 4) ^ (rows % 8))      # [N, 32]
    index = column.expand(k // BK, n, BK).to(w.device)
    return tuple(torch.gather(part, 2, index).contiguous()
                 for part in split_tf32(steps.float().contiguous()))


def plan(m, n, sms):
    """(N tile width, CTAs) of a kernel for an [m, n] output on ``sms``
    SMs: the widest of ``TILES`` that divides n; as many persistent CTAs
    as there are tiles, at most one an SM."""
    bn = 128 if n % 128 == 0 else 64
    return bn, min(-(-m // TILES[bn]) * (n // bn), sms)


@functools.lru_cache(maxsize=None)
def sms(device: int) -> int:
    """The SMs of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count
