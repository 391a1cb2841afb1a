"""Counter-based CMJ sampling on torch tensors, bit-exact with the reference.

Counterpart of ``rayito_tpu/ops/rng.py`` (Kensler correlated multi-jittered
sampling and the per-purpose seed hash). torch has no full uint32
arithmetic, so every uint32 value is held in an int64 tensor in
``[0, 2**32)``: logical shifts are plain shifts of non-negative values, and
wrapping multiplies are split into two 16-bit halves so no int64 product
can overflow. The streams are bit-identical to the JAX package's.

The Marsaglia MWC generator (the reference's oracle mode) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# float = u32 * 2.328306e-10f — the reference's canonical-float constant.
_CANONICAL = float(np.float32(2.328306e-10))


def u32(x, device=None) -> torch.Tensor:
    """uint32 value(s) as an int64 tensor in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, np.int64) & MASK32, device=device)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) and a Python int constant c."""
    c &= MASK32
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mul32_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for two tensors in [0, 2**32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def u32_to_float01(i: torch.Tensor) -> torch.Tensor:
    """Canonical [0,1) float from raw 32 bits, reference-style."""
    return i.to(torch.float32) * _CANONICAL


def cmj_permute(i: torch.Tensor, num: int, permutation: torch.Tensor):
    """Hash-based cycle-walking permutation of ``i`` in [0, num).

    The reference's do/while cycle walk becomes a masked loop that runs
    until every lane is inside [0, num). A power-of-two ``num`` can never
    leave the range, so no loop (and no host read) happens for it."""
    i = u32(i)
    permutation = u32(permutation)
    w = (num - 1) & MASK32
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16

    def round_fn(x):
        x = x ^ permutation
        x = _mul32(x, 0xE170893D)
        x = x ^ (permutation >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (permutation >> 8)
        x = _mul32(x, 0x0929EB3F)
        x = x ^ (permutation >> 23)
        x = x ^ ((x & w) >> 1)
        x = _mul32_t(x, 1 | (permutation >> 27))
        x = _mul32(x, 0x6935FA69)
        x = x ^ ((x & w) >> 11)
        x = _mul32(x, 0x74DCB303)
        x = x ^ ((x & w) >> 2)
        x = _mul32(x, 0x9E501CC3)
        x = x ^ ((x & w) >> 2)
        x = _mul32(x, 0xC860A3DF)
        x = x & w
        x = x ^ (x >> 5)
        return x

    i = round_fn(i)
    if num & (num - 1):
        while True:
            out = i >= num
            if not bool(out.any()):
                break
            i = torch.where(out, round_fn(i), i)
    return ((i + permutation) & MASK32) % num


def cmj_rand_float(i: torch.Tensor, permutation: torch.Tensor):
    """Avalanche hash -> canonical float in [0,1)."""
    i = u32(i)
    permutation = u32(permutation)
    i = i ^ permutation
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = _mul32_t(i, 1 | (permutation >> 18))
    return u32_to_float01(i)


def cmj_sample_1d(index: torch.Tensor, n: int, permutation: torch.Tensor):
    """1-D CMJ sample for a pattern of n samples."""
    permutation = u32(permutation)
    pidx = cmj_permute(index, n, _mul32(permutation, 0x8FF3CD11))
    sx = cmj_rand_float(pidx, _mul32(permutation, 0xA399D265))
    return (pidx.to(torch.float32) + sx) / float(n)


def cmj_sample_2d(index: torch.Tensor, nx: int, ny: int,
                  permutation: torch.Tensor):
    """2-D CMJ sample for an nx x ny pattern. Returns (d1, d2) in [0,1)."""
    permutation = u32(permutation)
    n = nx * ny
    pidx = cmj_permute(index, n, _mul32(permutation, 0xC2D3C8FB))
    ix = cmj_permute(pidx % nx, nx, _mul32(permutation, 0xA511E9B3))
    iy = cmj_permute(pidx // nx, ny, _mul32(permutation, 0x63D83595))
    sx = cmj_rand_float(pidx, _mul32(permutation, 0xA399D265))
    sy = cmj_rand_float(pidx, _mul32(permutation, 0x711AD6A5))
    d1 = (ix.to(torch.float32)
          + (iy.to(torch.float32) + sx) / float(ny)) / float(nx)
    d2 = (pidx.to(torch.float32) + sy) / float(n)
    return d1, d2


def hash_combine(*vals) -> torch.Tensor:
    """Mix a tuple of uint32 tensors/ints into one uint32 seed (the
    reference's Wang-hash style finalizer over an FNV-ish accumulator)."""
    device = next(
        (v.device for v in vals if isinstance(v, torch.Tensor)), None
    )
    h = u32(0x9E3779B9, device)
    for v in vals:
        v = u32(v, device)
        h = h ^ ((v + 0x9E3779B9 + ((h << 6) & MASK32) + (h >> 2)) & MASK32)
        h = (h ^ 61) ^ (h >> 16)
        h = (h + ((h << 3) & MASK32)) & MASK32
        h = h ^ (h >> 4)
        h = _mul32(h, 0x27D4EB2D)
        h = h ^ (h >> 15)
    return h


# Purpose salts (same values and meaning as the reference's table).
PURPOSE_SUBPIXEL = 0x51BD0010
PURPOSE_LENS = 0x51BD0020
PURPOSE_TIME = 0x51BD0030
PURPOSE_BOUNCE = 0x51BD0040
PURPOSE_LIGHT_SELECT = 0x51BD0050
PURPOSE_LIGHT_ELEMENT = 0x51BD0060
PURPOSE_LIGHT = 0x51BD0070
PURPOSE_BRDF = 0x51BD0080
