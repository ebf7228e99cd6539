"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level module names), and the reference imports nothing of the
program; a run without a card, or without the program, fails and prints
no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

from helpers import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_face"}


def _loaded(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``, run from the benchmark folder."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = "
         f"[{str(HERE)!r}, {str(ROOT)!r}]\n{code}\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, cwd=HERE, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


def test_harness_and_program_load_no_jax():
    metrics = sorted(p.name for p in (HERE / "metrics").glob("*.py"))
    code = ("import runpy, importlib, json, pathlib\n"
            "runpy.run_path('run.py', run_name='bench_run')\n"
            "import harness.core, harness.frames, harness.costs\n"
            "import entries.face_cascade, reference.cascade\n"
            "from harness.core import load_module\n"
            f"for m in {metrics!r}: load_module(pathlib.Path('metrics') / m)\n"
            "for t in pathlib.Path('traffic').glob('*.json'): "
            "json.loads(t.read_text())\n"
            "entries.face_cascade.build({'detector': 'BACK_CAMERA', "
            "'compute_dtype': 'float32', 'max_faces': 1, "
            "'warp_method': 'auto'}, 'cpu')\n")
    loaded = _loaded(code)
    assert "tpu_face_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded("import reference.cascade, reference.tflite")
    assert "tpu_face_torch" not in loaded and not loaded & FORBIDDEN
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "tpu_face_torch", "harness", "entries"}, (path, n)


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "back_f32.batch540", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=300)


def test_run_without_a_card_fails():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
