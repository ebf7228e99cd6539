"""ctypes binding of the native C++ JPEG batch decoder
``native/jpeg_loader.cc`` (counterpart of tpu_face/utils/native_loader.py).

Pillow decodes about a frame per millisecond on one core, which cannot
feed the card at thousands of frames/s; the native decoder (libjpeg
across a thread pool) decodes a batch into one contiguous [N, H, W, 3]
(or planar [N, 3, H, W]) uint8 array ready for the transfer.

The library is compiled from ``native/jpeg_loader.cc`` with ``g++`` at
first use into the git-ignored ``build/tpu_face_torch/``, under a name
keyed by a hash of the source and the flags, so a stale library is never
loaded; ``native/`` itself is read, never written (its own build product
belongs to the JAX package).  Where the library cannot be built (no
``g++`` or libjpeg) ``available()`` says so: ``decode_jpeg``/
``jpeg_info`` return None and the batch calls raise, and callers decode
with Pillow (``image_io.load_image``), as the JAX package does.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "jpeg_loader.cc"
BUILD_DIR = _ROOT / "build" / "tpu_face_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_tried = False


def library_path() -> Path:
    """Where the built decoder lies: keyed by the source and the flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libtpuface_loader_{key[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE), *LIBS], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)         # atomic: concurrent builders agree
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.tpuface_jpeg_info.restype = ctypes.c_int
    lib.tpuface_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tpuface_jpeg_decode.restype = ctypes.c_int
    lib.tpuface_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    lib.tpuface_jpeg_decode_batch.restype = ctypes.c_int
    lib.tpuface_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.tpuface_jpeg_decode_batch_planar.restype = ctypes.c_int
    lib.tpuface_jpeg_decode_batch_planar.argtypes = \
        lib.tpuface_jpeg_decode_batch.argtypes
    lib.tpuface_mjpeg_index.restype = ctypes.c_int
    lib.tpuface_mjpeg_index.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong,
        ctypes.POINTER(ctypes.c_ulong), ctypes.POINTER(ctypes.c_ulong),
        ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native decoder is built and loadable."""
    return _load() is not None


def jpeg_info(data: bytes):
    """(width, height) of a JPEG, or None if undecodable."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tpuface_jpeg_info(data, len(data), ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        return None
    return (w.value, h.value)


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Decode one JPEG to an RGB [H, W, 3] uint8 array (None on
    failure or when the native library is unavailable)."""
    lib = _load()
    if lib is None:
        return None
    info = jpeg_info(data)
    if info is None:
        return None
    w, h = info
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.tpuface_jpeg_decode(data, len(data),
                                 out.ctypes.data_as(ctypes.c_void_p),
                                 w, h)
    return out if rc == 0 else None


def decode_jpeg_batch(datas: Sequence[bytes], width: int, height: int,
                      num_threads: int = 0, strict: bool = False,
                      planar: bool = False):
    """Decode same-sized JPEGs into one [N, H, W, 3] uint8 array, or
    [N, 3, H, W] channel planes with ``planar=True`` (the layout
    ``FaceCascade(input_layout="planar")`` reads without a transpose).

    Frames that fail to decode (or whose size differs from (width,
    height)) come back zero-filled; ``strict=True`` raises on any
    failure, otherwise a nonzero count is warned once per call.
    ``num_threads`` 0 = one per CPU."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable — check g++ and "
                           "libjpeg, or use image_io.load_image")
    n = len(datas)
    shape = (n, 3, height, width) if planar else (n, height, width, 3)
    out = np.zeros(shape, np.uint8)
    if n == 0:
        return out
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    fn = (lib.tpuface_jpeg_decode_batch_planar if planar
          else lib.tpuface_jpeg_decode_batch)
    failures = fn(bufs, lens, out.ctypes.data_as(ctypes.c_void_p),
                  width, height, n, num_threads)
    if failures:
        msg = (f"decode_jpeg_batch: {failures}/{n} frames failed to "
               f"decode (zero-filled)")
        if strict:
            raise ValueError(msg)
        import warnings
        warnings.warn(msg, stacklevel=2)
    return out


def load_jpeg_batch(paths: Sequence, width: int, height: int,
                    num_threads: int = 0) -> np.ndarray:
    """Read + decode a batch of same-sized JPEG files."""
    datas: List[bytes] = [Path(p).read_bytes() for p in paths]
    return decode_jpeg_batch(datas, width, height, num_threads)


def mjpeg_split(data: bytes, max_frames: Optional[int] = None
                ) -> List[bytes]:
    """Split an MJPEG byte stream (concatenated JPEGs) into per-frame
    JPEG byte strings with the native segment parser (no false frame
    boundaries inside entropy-coded data)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable — check g++ and "
                           "libjpeg")
    # a realistic frame-size estimate; n == bound means the indexer may
    # have stopped early, so it retries larger unless the caller capped it
    bound = max_frames if max_frames is not None \
        else len(data) // 4096 + 16
    while True:
        offs = (ctypes.c_ulong * bound)()
        lens = (ctypes.c_ulong * bound)()
        n = lib.tpuface_mjpeg_index(data, len(data), offs, lens, bound)
        if n < bound or max_frames is not None:
            return [data[offs[i]:offs[i] + lens[i]] for i in range(n)]
        bound *= 4
