"""On the card, at each cell's own size: the program is correct against
the plain reference and the lower-precision control (bf16 nets) is not,
on one seed of the cell's full pool.  Skips without a CUDA card; run on
the card with ``python -m pytest benchmark/tests -m card``."""

import pytest
import torch

from helpers import CELLS, HERE, ROOT, SEED, bench


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_and_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from calibrate import readings
    from harness import frames
    from harness.core import Cell

    cell = Cell(bench(), name)
    device = torch.device("cuda", 0)
    pool = frames.make_pool(cell.traffic, HERE / "traffic", SEED, device)
    refs = cell.reference.run(cell.config, pool, ROOT)
    limits = cell.config["limits"]
    for dtype, ok in (("float32", True), ("bfloat16", False)):
        program = cell.entry.build(dict(cell.config, compute_dtype=dtype),
                                   device)
        nums = readings(cell, program, pool, refs)
        assert all(v <= limits[n] for n, v in nums.items()) == ok, (dtype,
                                                                    nums)
