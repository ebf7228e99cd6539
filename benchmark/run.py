"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``tpu_face_torch``),
its weights (``tpu_face/data``) and ``BENCHMARK.json``.  It runs on the
CUDA cards of the machine it starts on and exits non-zero, printing no
result, without as many cards as the cell asks for.  The last line of
its standard output is the run's result as JSON; the numbers the
correctness check compared, each beside its limit, are the last lines
of its standard error.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(1, str(ROOT))

from harness.core import (Cell, forbidden_modules, log,  # noqa: E402
                          run_cell)

T_IMPORTS = time.perf_counter()


def fail(msg, code=1):
    log(f"benchmark: {msg}")
    raise SystemExit(code)


def log_power_limit(chips):
    """The cards' names and power limits, as ``nvidia-smi`` reads them
    (after the window: a subprocess is no part of set-up)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = ["nvidia-smi: not available"]
    log(f"device: {smi[:chips]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    if not (ROOT / "tpu_face_torch" / "__init__.py").exists():
        fail(f"no tpu_face_torch package in {ROOT}")
    import torch

    log(f"setup imports (torch, the harness): {T_IMPORTS - T_START:.3f} s")
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark measures the port on the card")
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA card(s), the cell asks for "
             f"{chips}")
    import tpu_face_torch

    if Path(tpu_face_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"tpu_face_torch comes from {tpu_face_torch.__file__}, not "
             f"from the checkout")
    record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, ROOT, record)
    log_power_limit(chips)
    found = forbidden_modules()
    if found:
        fail(f"the run loaded {found}: the port runs without JAX and its "
             f"package")
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
