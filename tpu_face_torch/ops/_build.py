"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use into ``build/tpu_face_torch/``
at the repository root, under a name keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a stale library is never
loaded; the library is opened with ``ctypes``.  ``build_all`` starts one
``nvcc`` per source at once.  Nothing here runs when the module is
imported: the CPU-only test environment has no ``nvcc``.  ``entry`` and
``launch`` are the lean launch path every kernel wrapper shares;
``register`` makes a kernel a PyTorch operator in the ``tpu_face_torch``
namespace.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_face_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

# (planes, stride_b, stride_c, stride_h, batch, h, w, xs, ys, p, out,
#  stream) -> cudaError_t, the entry points of the strip warp
_WARP_SIG = ((_P, _I64, _I64, _I64, _I, _I, _I, _P, _P, _I, _P, _P), _I)

# (planes, stride_b, stride_c, stride_h, batch, h, w, segment table,
#  segments, p, out, stream) -> cudaError_t, the segment warp's entry
#  point; the table is nseg rows of int64 (xs, ys, p, width)
_SEGMENT_WARP_SIG = ((_P, _I64, _I64, _I64, _I, _I, _I, _P, _I, _I, _P, _P),
                     _I)

# (x, out, packed weights, batch, c, h, w, layers, tile, stream) ->
# cudaError_t, the entry points of the f32 and the bf16 fused
# residual-block kernels
_BLOCK_SIG = ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I)

# (planes, batch, h, w, xs, ys, groups, gh, gw, rt, cw, cap, out, stats,
#  stream) -> cudaError_t, the entry points of the staged strip warp
_STAGED_SIG = ((_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
               _I)

# (pred, negate, body stream, stream) -> cudaError_t and (stream) ->
# cudaError_t: the IF node of programs.cond, begun on the capturing
# stream with its body captured from ``body``, and the body's end
_IF_BEGIN_SIG = ((_P, _I, _P, _P), _I)
_IF_END_SIG = ((_P,), _I)

# (ring, sequence number, slot, stream), (ring, slot, stream) and (stamp,
# host int64[3], stream) -> cudaError_t: utils/profiling's device stamps,
# the call's first (which takes its row of the ring), a later one, and the
# clock pairing's
_STAMP_OPEN_SIG = ((_P, _I64, _I, _P), _I)
_STAMP_SIG = ((_P, _I, _P), _I)
_STAMP_PAIR_SIG = ((_P, _P, _P), _I)

# (y, bias, skip, alpha, out, batch, c, c_skip, hw, channels_last, act,
#  stream) -> cudaError_t, the convolution epilogue's entry point
_EPILOGUE_SIG = ((_P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I, _I, _P), _I)

# (x, w_hi, w_lo, scale, shift, y, batch, h, w, cin, cout, stride, pad,
#  N tile, CTAs, tf32, stream) -> cudaError_t, the split-TF32 3x3
#  convolution's entry point (scale and shift null: no input affine)
_CONV_TC_SIG = ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _P), _I)

# (x, w_hi, w_lo, bias, y, M, K, N, activation, N tile, CTAs, tf32,
#  stream) -> cudaError_t, the split-TF32 token FC's entry point (bias
#  null: none)
_FC_TC_SIG = ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P), _I)

# (q, k, v, scale, bias, mask, o, seqs, n, heads, d, nw, tf32, stream) ->
#  cudaError_t, the attention core's entry point (scale, bias and mask
#  null: none)
_ATTENTION_TC_SIG = ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P), _I)

# C signature of each library's entry points: {function: (argtypes,
# restype)}
SIGNATURES = {
    "attention_tc": {"attention_tc_f32": _ATTENTION_TC_SIG},
    "conv_epilogue": {"conv_epilogue_f32": _EPILOGUE_SIG},
    "conv3x3_tc": {"conv3x3_tc_f32": _CONV_TC_SIG},
    "fc_tc": {"fc_tc_f32": _FC_TC_SIG},
    "graph_cond": {"graph_if_begin": _IF_BEGIN_SIG,
                   "graph_if_end": _IF_END_SIG},
    "stage_stamp": {"stage_stamp_open": _STAMP_OPEN_SIG,
                    "stage_stamp": _STAMP_SIG,
                    "stage_stamp_pair": _STAMP_PAIR_SIG},
    "warp_bilinear": {"warp_bilinear": _SEGMENT_WARP_SIG},
    "warp_bilinear_strips": {"warp_bilinear_strips_bf16": _WARP_SIG,
                             "warp_bilinear_strips_f32": _WARP_SIG},
    "fused_dw_pw_block": {"fused_dw_pw_block_f32": _BLOCK_SIG},
    "fused_dw_pw_block_bf16": {"fused_dw_pw_block_bf16": _BLOCK_SIG},
    "warp_strips_staged": {f"warp_strips_staged_{copies}_{t}": _STAGED_SIG
                           for copies in ("fused", "split")
                           for t in ("bf16", "f32")},
}

# the operators' namespace, tpu_face_torch::<name> (``register``)
_OPS = torch.library.Library("tpu_face_torch", "FRAGMENT")

_LIBS = {}
_ENTRIES = {}    # entry point name -> ctypes function
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


def _target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu``, keyed by its content and
    that of the headers beside it (``csrc/*.cuh``), which it may
    include."""
    content = b"".join(p.read_bytes() for p in (
        _CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))))
    digest = hashlib.sha256(content
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one
    ``nvcc`` per source, all started together; return {name: library
    path}."""
    libs = {name: _target(name) for name in names}
    jobs = {}
    t0 = time.perf_counter()
    for name, lib in libs.items():
        if lib.exists():
            # a library built earlier in this process keeps its log
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "",
                                        "cached": True})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src = _CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{err}")
            continue
        os.replace(tmp, libs[name])
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": err.strip(), "cached": False}
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library (cached by
    content) and return its path."""
    return build_all([name])[name]


def load(name: str):
    """The kernel library ``name`` with its entry points' ctypes
    signatures set; built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[name] = lib
    return _LIBS[name]


def entry(name: str, fn_name: str):
    """The ctypes entry point ``fn_name`` of library ``name``, resolved
    (the library built and loaded) on first use only."""
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = _ENTRIES[fn_name] = getattr(load(name), fn_name)
    return fn


def launch(fn, device: int, *args):
    """``fn(*args, stream)`` on the current stream of CUDA device index
    ``device`` (``Tensor.get_device()``); raises if the entry point
    returns a CUDA error.  Kept lean, since a small kernel's launch costs
    less device time than this host path: the raw stream handle comes
    from ``torch._C._cuda_getCurrentRawStream`` (no Stream object), and
    the device's context is entered only when it is not the current
    one."""
    if device == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def register(name, schema, cpu, cuda, fake):
    """Define the operator ``tpu_face_torch::<name><schema>`` with its CPU
    implementation (a kernel's plain version), its CUDA implementation
    (the launch) and its fake implementation (the output's shape and
    type, for ``torch.export``); returns its overload.  The low-level
    ``torch.library.Library`` route: a call costs less host time than one
    through ``torch.library.custom_op``."""
    _OPS.define(f"{name}{schema}")
    _OPS.impl(name, cpu, "CPU")
    _OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tpu_face_torch::{name}", fake, lib=_OPS)
    return getattr(torch.ops.tpu_face_torch, name).default
