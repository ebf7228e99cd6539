"""The PyTorch port stands alone: no module of tpu_face_torch, and not
chip_smoke.py, imports JAX or the JAX package.

Checked on the source with ``ast`` rather than through ``sys.modules``:
the test process imports both packages (and an environment may
pre-import jax), so only the source says what the port itself needs.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tpu_face")
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "tpu_face_torch").rglob("*.py"))
FILES.append("chip_smoke.py")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_port_module_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    roots = set(_imported_roots(tree))
    assert not roots & set(FORBIDDEN), (path, sorted(roots))


def test_port_covers_the_slice():
    """Every module of the slice exists (the parametrized check above
    would pass vacuously on a missing file)."""
    want = {"tpu_face_torch/__init__.py",
            "tpu_face_torch/compiler/lowering.py",
            "tpu_face_torch/ops/anchors.py",
            "tpu_face_torch/ops/image.py",
            "tpu_face_torch/ops/postprocess.py",
            "tpu_face_torch/ops/warp.py",
            "tpu_face_torch/ops/_build.py",
            "tpu_face_torch/ops/fused_block.py",
            "tpu_face_torch/ops/geometry.py",
            "tpu_face_torch/types.py",
            "tpu_face_torch/models/__init__.py",
            "tpu_face_torch/models/face_detection.py",
            "tpu_face_torch/models/face_landmark.py",
            "tpu_face_torch/models/iris_landmark.py",
            "tpu_face_torch/utils/image_io.py",
            "tpu_face_torch/pipeline.py",
            "tpu_face_torch/tracking.py",
            "tpu_face_torch/smoothing.py",
            "tpu_face_torch/models/face_embeddings.py",
            "tpu_face_torch/render.py",
            "tpu_face_torch/utils/profiling.py",
            "tpu_face_torch/utils/native_loader.py",
            "tpu_face_torch/__main__.py",
            "tpu_face_torch/aot.py",
            "tpu_face_torch/parallel/__init__.py",
            "tpu_face_torch/parallel/sharding.py"}
    assert want <= set(FILES)
    for kernel in ("warp_bilinear", "warp_bilinear_strips",
                   "fused_dw_pw_block", "fused_dw_pw_block_bf16",
                   "warp_strips_staged"):
        assert (ROOT / f"tpu_face_torch/csrc/{kernel}.cu").exists()
