"""Image helpers mirroring the BasicSR utility surface the reference
consumes (``imfrombytes``, ``img2tensor``), as the JAX package's
``utils/img.py``: channels-last numpy arrays, RGB."""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def imfrombytes(content: bytes, flag: str = "color",
                float32: bool = False) -> np.ndarray:
    """Decode an encoded image buffer to RGB (the reference decodes with cv2
    and flips to RGB)."""
    flags = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}[flag]
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags)
    if img is None:
        raise ValueError("imfrombytes: decode failed")
    if flag == "color":
        img = img[..., ::-1]
    if float32:
        img = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img)


def img2array(img: np.ndarray, to_float: bool = True) -> np.ndarray:
    """HWC uint8 -> channels-last float [0,1] (the models' layout; the torch
    ``img2tensor`` without the CHW permute)."""
    out = np.asarray(img)
    if to_float and out.dtype == np.uint8:
        out = out.astype(np.float32) / 255.0
    return out


def array2img(arr: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 HWC with rounding + clamping."""
    return np.clip(np.round(np.asarray(arr, np.float64) * 255.0), 0,
                   255).astype(np.uint8)
