"""The renderer's sample streams, frozen for the reference: Kensler's
correlated multi-jittered sampling (Pixar technical memo 13-01) keyed by a
hash of (pixel, purpose, bounce, seed), as the Rayito renderer draws them.

Plain integer numpy on the host: every uint32 value is held in a uint64
array and masked after each product, so nothing wraps by accident. The
floats come out as float32, each step rounded once, as the renderer takes
them.
"""

from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
CANONICAL = np.float32(2.328306e-10)

# purpose salts
SUBPIXEL = 0x51BD0010
LENS = 0x51BD0020
TIME = 0x51BD0030
BOUNCE = 0x51BD0040
LIGHT_SELECT = 0x51BD0050
LIGHT_ELEMENT = 0x51BD0060
LIGHT = 0x51BD0070
BRDF = 0x51BD0080


def _u(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64) & M32


def _mul(a, c) -> np.ndarray:
    """(a * c) mod 2**32 for uint32 values held in uint64."""
    a, c = _u(a), _u(c)
    lo = a * (c & np.uint64(0xFFFF))
    hi = ((a * (c >> np.uint64(16))) & np.uint64(0xFFFF)) << np.uint64(16)
    return (lo + hi) & M32


def _sh(x, s):
    return x >> np.uint64(s)


def hash_combine(*vals) -> np.ndarray:
    h = _u(0x9E3779B9)
    for v in vals:
        v = _u(v)
        h = h ^ ((v + _u(0x9E3779B9) + ((h << np.uint64(6)) & M32)
                  + _sh(h, 2)) & M32)
        h = (h ^ np.uint64(61)) ^ _sh(h, 16)
        h = (h + ((h << np.uint64(3)) & M32)) & M32
        h = h ^ _sh(h, 4)
        h = _mul(h, 0x27D4EB2D)
        h = h ^ _sh(h, 15)
    return h


def _permute(i, num: int, p) -> np.ndarray:
    """Kensler's cycle-walking permutation of i in [0, num)."""
    w = (num - 1) & 0xFFFFFFFF
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    w = np.uint64(w)
    p = _u(p)

    def rnd(x):
        x = x ^ p
        x = _mul(x, 0xE170893D)
        x = x ^ _sh(p, 16)
        x = x ^ _sh(x & w, 4)
        x = x ^ _sh(p, 8)
        x = _mul(x, 0x0929EB3F)
        x = x ^ _sh(p, 23)
        x = x ^ _sh(x & w, 1)
        x = _mul(x, np.uint64(1) | _sh(p, 27))
        x = _mul(x, 0x6935FA69)
        x = x ^ _sh(x & w, 11)
        x = _mul(x, 0x74DCB303)
        x = x ^ _sh(x & w, 2)
        x = _mul(x, 0x9E501CC3)
        x = x ^ _sh(x & w, 2)
        x = _mul(x, 0xC860A3DF)
        x = x & w
        return x ^ _sh(x, 5)

    i = rnd(_u(i))
    while True:  # do { ... } while (i >= num)
        out = i >= np.uint64(num)
        if not out.any():
            break
        i = np.where(out, rnd(i), i)
    return ((i + p) & M32) % np.uint64(num)


def _randfloat(i, p) -> np.ndarray:
    i, p = _u(i), _u(p)
    i = i ^ p
    i = i ^ _sh(i, 17)
    i = i ^ _sh(i, 10)
    i = _mul(i, 0xB36534E5)
    i = i ^ _sh(i, 12)
    i = i ^ _sh(i, 21)
    i = _mul(i, 0x93FC4795)
    i = i ^ np.uint64(0xDF6E307F)
    i = i ^ _sh(i, 17)
    i = _mul(i, np.uint64(1) | _sh(p, 18))
    return i.astype(np.float32) * CANONICAL


def _index(si, mul: int, add: int):
    return (_u(si) * np.uint64(mul & 0xFFFFFFFF)
            + np.uint64(add & 0xFFFFFFFF)) & M32


def sample_1d(si, n: int, p, mul: int = 1, add: int = 0) -> np.ndarray:
    i = _index(si, mul, add)
    pidx = _permute(i, n, _mul(p, 0x8FF3CD11))
    sx = _randfloat(pidx, _mul(p, 0xA399D265))
    return (pidx.astype(np.float32) + sx) / np.float32(n)


def sample_2d(si, nx: int, ny: int, p, mul: int = 1, add: int = 0):
    i = _index(si, mul, add)
    n = nx * ny
    pidx = _permute(i, n, _mul(p, 0xC2D3C8FB))
    ix = _permute(pidx % np.uint64(nx), nx, _mul(p, 0xA511E9B3))
    iy = _permute(pidx // np.uint64(nx), ny, _mul(p, 0x63D83595))
    sx = _randfloat(pidx, _mul(p, 0xA399D265))
    sy = _randfloat(pidx, _mul(p, 0x711AD6A5))
    d1 = (ix.astype(np.float32)
          + (iy.astype(np.float32) + sx) / np.float32(ny)) / np.float32(nx)
    d2 = (pidx.astype(np.float32) + sy) / np.float32(n)
    return d1, d2
