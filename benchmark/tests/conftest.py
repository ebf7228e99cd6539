"""The benchmark's own tests: the harness on the CPU at tiny sizes.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``card`` need a CUDA card and decide so inside the test."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")
