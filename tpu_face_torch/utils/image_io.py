"""Host-side image decoding and small vector helpers (counterpart of
tpu_face/utils/image_io.py).

Frames are decoded once on the host with Pillow (already RGB); everything
after the decode runs on the device.  ``l2_norm`` and
``similarity_score`` are host numpy, the JAX module's arithmetic.
"""

import io
import warnings
from pathlib import Path

import numpy as np


def load_image(src) -> np.ndarray:
    """Decode to an RGB uint8 array [H, W, 3].

    Accepts a path, raw bytes, a PIL image, or an ndarray (passed through).
    """
    if isinstance(src, np.ndarray):
        if src.ndim != 3 or src.shape[-1] != 3:
            raise ValueError(f"expected [H,W,3] image, got {src.shape}")
        if src.dtype == np.uint8:
            return src
        if np.issubdtype(src.dtype, np.floating):
            # Both float conventions are accepted: [0, 1] (scaled up) and
            # [0, 255]; round+clip rather than truncate/wrap.
            arr = np.asarray(src, dtype=np.float64)
            if not np.isfinite(arr).all():
                raise ValueError("image contains NaN/Inf pixels")
            if arr.size and arr.max() <= 1.0:
                if arr.max() > 0.0:
                    warnings.warn(
                        "load_image: float image with max <= 1.0 treated "
                        "as [0,1]-scaled and multiplied by 255; pass uint8 "
                        "or [0,255] floats to silence this",
                        stacklevel=2)
                arr = arr * 255.0
            return np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        return np.clip(src, 0, 255).astype(np.uint8)
    from PIL import Image
    if isinstance(src, (str, Path)):
        img = Image.open(src)
    elif isinstance(src, (bytes, bytearray)):
        img = Image.open(io.BytesIO(src))
    else:
        img = src  # assume PIL image
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def l2_norm(arr: np.ndarray) -> np.ndarray:
    """L2-normalize a vector/matrix by its global norm
    (reference utils.rs:30-33)."""
    return arr / np.sqrt(np.sum(np.square(arr)))


def similarity_score(a, b) -> float:
    """Cosine similarity (reference utils.rs:44-50)."""
    a = np.asarray(a, dtype=np.float32).ravel()
    b = np.asarray(b, dtype=np.float32).ravel()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
