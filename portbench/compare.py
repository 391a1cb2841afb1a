"""How ``correct`` is decided: a seeded sample of pixels of every render
in the window against the plain reference's value of the same pixels.

A pixel matches when every channel lies within ``RTOL`` of the
reference's brightest channel plus ``ATOL``. Rounding alone (the same
paths, float32 operations in another order) stays orders of magnitude
inside that; a path that turns another way at a knife edge (a ray through
a triangle edge, a shadow boundary) takes the pixel outside it, and so
does every pixel of a render computed in a lower precision. The number
compared is the share of sampled pixels that do not match, in the worst
render of the window, against ``MISMATCH_LIMIT`` (set in PERF.md from the
program's readings over a dozen seeds and the bfloat16 control's).
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-3
ATOL = 1e-5
# the share of sampled pixels allowed to differ: above the program's
# knife-edge paths, below the bfloat16 control (PERF.md section 2)
MISMATCH_LIMIT = 0.02
# pixels drawn per run; every pixel of a frame that has fewer
PIXELS = 16384


def sample_pixels(seed: int, width: int, height: int, k: int = PIXELS):
    """Flat row-major indices of ``k`` distinct pixels drawn from
    ``seed``, sorted (every pixel of a frame of at most ``k``)."""
    n = width * height
    if n <= k:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**63 - 1),
                                                        0x5EED]))
    return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)


def mismatch(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per pixel ([K, 3] against [K, 3]): True where it does not match
    (NaN and infinity never match)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    tol = RTOL * np.abs(ref).max(axis=1) + ATOL
    ok = (np.abs(got - ref) <= tol[:, None]).all(axis=1)
    return ~ok


def mismatch_share(got: np.ndarray, ref: np.ndarray) -> float:
    return float(mismatch(got, ref).mean()) if len(ref) else 1.0
