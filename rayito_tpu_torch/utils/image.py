"""Image output and diagnostics, numpy-only (counterpart of
``rayito_tpu/utils/image.py``). Framebuffers are float32 [H, W, 3] in
screen orientation (row 0 = top)."""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, img) -> None:
    """Binary P6 PPM, clamped to [0,1], scaled by 255 and truncated."""
    data = quantize_ppm(img)
    h, w = data.shape[0], data.shape[1]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(data.tobytes())


def quantize_ppm(img) -> np.ndarray:
    """The uint8 image exactly as write_ppm encodes it."""
    img = np.asarray(img, dtype=np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def diagnose(img) -> dict:
    """NaN / negative pixel counts and the value range."""
    img = np.asarray(img)
    nan_mask = np.isnan(img).any(axis=-1)
    neg_mask = (~nan_mask) & (img < 0.0).any(axis=-1)
    return {
        "nan_pixels": int(nan_mask.sum()),
        "negative_pixels": int(neg_mask.sum()),
        "min": float(np.nanmin(img)) if img.size else 0.0,
        "max": float(np.nanmax(img)) if img.size else 0.0,
    }
