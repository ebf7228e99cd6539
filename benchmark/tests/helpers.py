"""Shared pieces of the benchmark's tests."""

import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELLS = ("back_f32.batch540", "full_sparse_k4_f32.crowd720")
SEED = 2**31 + 12345


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name, here=HERE, bench_doc=None, **config):
    """The cell with a traffic of two batches of two frames, its
    configuration updated by ``config``."""
    from harness.core import Cell

    cell = Cell(bench_doc or bench(), name, here=here)
    cell.traffic.update(batch=2, pool=2)
    cell.config.update(config)
    return cell


def run_tiny(cell, seed=SEED, traced=False):
    """One run of ``cell`` on the CPU, no window to speak of: every pool
    batch called once."""
    from harness.core import run_cell

    return run_cell(cell, seed, 0.0, traced, "cpu", time.perf_counter(),
                    ROOT)
