"""Image I/O, tone mapping and diagnostics, numpy-only (counterpart of
``rayito_tpu/utils/image.py``; every writer emits the reference's bytes).
Framebuffers are float32 [H, W, 3] in screen orientation (row 0 = top)."""

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


def read_ppm(path: str) -> np.ndarray:
    """A binary P6 PPM (maxval 255; comments and any whitespace in the
    header) as a uint8 [H, W, 3] array."""
    with open(path, "rb") as f:
        raw = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(raw) and raw[i:i + 1].isspace():
            i += 1
        if raw[i:i + 1] == b"#":  # a comment runs to the end of its line
            while i < len(raw) and raw[i:i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(raw) and not raw[i:i + 1].isspace():
            i += 1
        tokens.append(raw[start:i])
    if tokens[0] != b"P6":
        raise ValueError(f"not a binary PPM: {tokens[0]!r}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    i += 1  # the one whitespace byte after maxval
    data = np.frombuffer(raw, dtype=np.uint8, count=w * h * 3, offset=i)
    return data.reshape(h, w, 3)


def write_pfm(path: str, img) -> None:
    """Colour PFM: little-endian (scale -1.0) binary floats, rows
    bottom-up, as the PFM format has them."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[0], img.shape[1]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(img[::-1].astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """A colour PFM (binary floats, rows bottom-up; a negative scale means
    little-endian) as [H, W, 3] float32, top row first."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError(f"{path}: not a colour PFM")
        w, h = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 3 * 4),
                             dtype="<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].astype(np.float32)


def tone_map(img, exposure: float = 0.0, gamma: float = 2.2) -> np.ndarray:
    """The GUI's tone map, (value * 2^exposure)^(1/gamma), clamped to
    [0, 1]. Returns float32."""
    img = np.asarray(img, dtype=np.float32)
    out = np.maximum(img * (2.0 ** exposure), 0.0) ** (1.0 / gamma)
    return np.clip(out, 0.0, 1.0)


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


def diagnostic_colors(img) -> np.ndarray:
    """NaN pixels painted blue and negative pixels green, as the GUI shows
    them."""
    img = np.asarray(img, dtype=np.float32).copy()
    nan_mask = np.isnan(img).any(axis=-1)
    neg_mask = (~nan_mask) & (img < 0.0).any(axis=-1)
    img[nan_mask] = np.array([0.0, 0.0, 1.0], np.float32)
    img[neg_mask] = np.array([0.0, 1.0, 0.0], np.float32)
    return img


def rmse_8bit(a, b) -> float:
    """Per-channel RMSE of two uint8 images on the [0, 1] scale."""
    a = np.asarray(a, dtype=np.float64) / 255.0
    b = np.asarray(b, dtype=np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))
