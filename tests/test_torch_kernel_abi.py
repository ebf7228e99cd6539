"""The ctypes signatures the kernel wrappers launch through
(``tpu_face_torch/ops/_build.SIGNATURES``) against the C entry points of
``tpu_face_torch/csrc/``, read from the sources on the CPU (no nvcc
here): each entry point exists, and its parameters, in order, have the
kinds ctypes passes (a pointer, a 64-bit or a 32-bit int).  A mismatch
would pass arguments into the wrong parameters on the card.
"""

import ctypes
import re
from pathlib import Path

import pytest

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
ENTRIES = [(lib, fn) for lib, fns in sorted(_build.SIGNATURES.items())
           for fn in sorted(fns)]


def _params(lib: str, fn: str):
    """The C parameter declarations of entry point ``fn`` in
    ``csrc/<lib>.cu``: declared directly as ``extern "C" int fn(...)``,
    or made by a macro ``M(fn, ...)`` whose body declares
    ``extern "C" int name(...)``."""
    src = (CSRC / f"{lib}.cu").read_text().replace("\\\n", "\n")
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    if m is None:
        call = re.search(rf"^(\w+)\({fn},", src, re.M)
        assert call is not None, f"no entry point {fn} in csrc/{lib}.cu"
        macro = re.search(rf"#define {call.group(1)}\(name[^)]*\)\s*"
                          rf'extern "C" int name\(([^)]*)\)', src)
        assert macro is not None, call.group(1)
        m = macro
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _kind(decl: str):
    if "*" in decl:
        return ctypes.c_void_p
    if decl.startswith("int64_t "):
        return ctypes.c_int64
    assert decl.startswith("int "), decl
    return ctypes.c_int


@pytest.mark.parametrize("lib,fn", ENTRIES)
def test_signature_matches_the_c_entry_point(lib, fn):
    argtypes, restype = _build.SIGNATURES[lib][fn]
    params = _params(lib, fn)
    assert [_kind(p) for p in params] == list(argtypes), (fn, params)
    assert params[-1] == "void* stream" and restype is ctypes.c_int
