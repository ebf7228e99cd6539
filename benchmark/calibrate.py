"""The readings the correctness limits are set from, on the card:

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: the cell's frame pool, the configuration's
program and its control (the same program with its nets one precision
below the configuration's float32: ``CONTROL_DTYPE``), each called
``SAMPLES_PER_BATCH`` times on every pool batch as a run's sample is,
and the plain reference on the pool; then every
number the run compares, for the program and for the control.  Prints a
line per seed and side, and the largest reading of the program and the
smallest of the control for each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(1, str(ROOT))

from harness import frames  # noqa: E402
from harness.core import (SAMPLES_PER_BATCH, Cell, compare,  # noqa: E402
                          log)

CONTROL_DTYPE = "bfloat16"


def readings(cell, program, pool, refs):
    """The comparison's numbers for ``program`` over the pool, each batch
    called ``SAMPLES_PER_BATCH`` times."""
    kept = {p: [cell.entry.call(program, batch)
                for _ in range(SAMPLES_PER_BATCH)]
            for p, batch in enumerate(pool)}
    return {n: v for n, (v, _) in compare(cell, kept, refs).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    device = torch.device("cuda", 0)
    program = cell.entry.build(cell.config, device)
    control = cell.entry.build(dict(cell.config,
                                    compute_dtype=CONTROL_DTYPE), device)
    rows = {"program": [], "control": []}
    for seed in args.seeds:
        t = time.perf_counter()
        pool = frames.make_pool(cell.traffic, HERE / "traffic", seed, device)
        refs = cell.reference.run(cell.config, pool, ROOT)
        faces = sum(float(r["face_valid"].sum()) for r in refs) / (
            len(pool) * cell.traffic["batch"])
        for side, prog in (("program", program), ("control", control)):
            nums = readings(cell, prog, pool, refs)
            rows[side].append(nums)
            print(json.dumps({"seed": seed, "side": side,
                              "faces_per_frame": faces, **nums}), flush=True)
        log(f"seed {seed}: {time.perf_counter() - t:.1f} s")
    lower = {n: max(r[n] for r in rows["program"]) for n in rows["program"][0]}
    upper = {n: min(r[n] for r in rows["control"]) for n in lower}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "program_max": lower, "control_min": upper}))


if __name__ == "__main__":
    main()
