"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use into ``build/tpu_face_torch/``
at the repository root, under a name keyed by a hash of the source and
the flags, so a stale library is never loaded; the library is opened
with ``ctypes``.  Nothing here runs when the module is imported: the
CPU-only test environment has no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_face_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

# C signature of each kernel's entry point: (argtypes, restype)
SIGNATURES = {
    "warp_bilinear": ((_P, _I64, _I64, _I64, _I, _I, _I, _P, _P, _I, _P,
                       _P), _I),
}

_LIBS = {}
BUILD_LOG = {}   # name -> {"seconds": float, "ptxas": str, "cached": bool}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library (cached by
    content) and return its path."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if lib.exists():
        BUILD_LOG[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr.strip(), "cached": False}
    return lib


def load(name: str):
    """The kernel library ``name`` with its entry point's ctypes
    signature set; built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
        _LIBS[name] = lib
    return _LIBS[name]
