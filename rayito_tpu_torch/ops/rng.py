"""Counter-based CMJ sampling on torch tensors, bit-exact with the reference.

Counterpart of ``rayito_tpu/ops/rng.py`` (Kensler correlated multi-jittered
sampling and the per-purpose seed hash). The streams are bit-identical to
the JAX package's.

The integrators draw through ``cmj_draws``: a draw set (every draw of one
bounce, of the camera or of a direct-lighting pass: a tuple of ``Draw``)
in one launch of the ``cmj`` kernel on CUDA tensors (``csrc/cmj.cu``
``cmj_draws_kernel``: native uint32, one thread per lane, the seeds in
registers, each lane its own cycle walk), its plain version
``cmj_draws_plain`` on CPU tensors. The single draws ``hash_combine``,
``cmj_sample_1d`` and ``cmj_sample_2d`` (the samplers', the plain
version's and the tests') launch no kernel: they are torch ops on every
device. torch has no full uint32 arithmetic, so they hold every uint32
value in an int64 tensor in ``[0, 2**32)``: logical shifts are plain
shifts of non-negative values, and wrapping multiplies are split into two
16-bit halves so no int64 product can overflow.

The Marsaglia MWC generator is the reference's oracle mode only: no
integrator draws from it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_lib
from .vec3 import div_scalar as _div

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


MWC_Z0 = 362436069
MWC_W0 = 521288629


def mwc_init(z=MWC_Z0, w=MWC_W0, device=None):
    """Fresh Marsaglia multiply-with-carry state; z, w may be sequences for
    a batch of streams."""
    return u32(z, device), u32(w, device)


def mwc_next_u32(state):
    """Advance MWC; returns (new_state, u32). The reference's recurrence
    z = 36969 (z & 65535) + (z >> 16), w likewise with 18000; both products
    stay below 2**32, so no int64 term can overflow."""
    z, w = state
    z = (36969 * (z & 0xFFFF) + (z >> 16)) & MASK32
    w = (18000 * (w & 0xFFFF) + (w >> 16)) & MASK32
    return (z, w), (((z << 16) & MASK32) + w) & MASK32


def mwc_next_float(state):
    state, i = mwc_next_u32(state)
    return state, u32_to_float01(i)


def _permute_w(num: int) -> int:
    """The cycle walk's mask: the least 2**k - 1 >= num - 1."""
    w = (num - 1) & MASK32
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    return w


def _permute_round(x: torch.Tensor, permutation: torch.Tensor, w: int):
    """One round of the cycle walk: a bijection on [0, w]."""
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


def cmj_permute(i: torch.Tensor, num: int, permutation: torch.Tensor,
                fixed_rounds: bool | None = None):
    """Hash-based cycle-walking permutation of ``i`` in [0, num).

    The reference's do/while cycle walk becomes masked rounds. On a CUDA
    tensor (or with ``fixed_rounds=True``) it runs exactly ``(w + 1) -
    num`` of them, decided on the host, with no read of the device (a CUDA
    graph can hold it): the round function is a bijection on [0, w], so the
    out-of-range values one walk visits are distinct, at most
    ``(w + 1) - num`` of them, and a lane already in range does not move in
    the rounds after it arrives. On the CPU the loop stops once every lane
    is in range, as the reference's does, with the same result. A power of
    two runs no extra round."""
    i = u32(i)
    permutation = u32(permutation)
    w = _permute_w(num)
    i = _permute_round(i, permutation, w)
    fixed = i.is_cuda if fixed_rounds is None else fixed_rounds
    for _ in range((w + 1) - num):
        out = i >= num
        if not fixed and not bool(out.any()):
            break
        i = torch.where(out, _permute_round(i, permutation, w), i)
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


def _index(index, index_mul: int, index_add: int):
    """The sample index u32(index) * index_mul + index_add (mod 2**32)."""
    if index_mul == 1 and index_add == 0:
        return index
    return (u32(index) * (index_mul & MASK32) + (index_add & MASK32)) & MASK32


def _on_cpu(name, vals) -> bool:
    """True: no tensor operand, or CPU tensors; False: tensors on one CUDA
    device. Tensors on more than one device raise."""
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    return not tensors or cuda_lib.on_cpu(name, *tensors)


def cmj_sample_1d(index, n: int, permutation, index_mul: int = 1,
                  index_add: int = 0):
    """1-D CMJ sample for a pattern of n samples, of the index
    ``index * index_mul + index_add``."""
    _on_cpu("cmj_sample_1d", (index, permutation))  # raises for two devices
    index = _index(index, index_mul, index_add)
    permutation = u32(permutation)
    pidx = cmj_permute(index, n, _mul32(permutation, 0x8FF3CD11))
    sx = cmj_rand_float(pidx, _mul32(permutation, 0xA399D265))
    return _div(pidx.to(torch.float32) + sx, n)


def cmj_sample_2d(index, nx: int, ny: int, permutation, index_mul: int = 1,
                  index_add: int = 0):
    """2-D CMJ sample for an nx x ny pattern, of the index ``index *
    index_mul + index_add``. Returns (d1, d2) in [0,1)."""
    _on_cpu("cmj_sample_2d", (index, permutation))  # raises for two devices
    index = _index(index, index_mul, index_add)
    permutation = u32(permutation)
    n = nx * ny
    pidx = cmj_permute(index, n, _mul32(permutation, 0xC2D3C8FB))
    ix = cmj_permute(pidx % nx, nx, _mul32(permutation, 0xA511E9B3))
    iy = cmj_permute(pidx // nx, ny, _mul32(permutation, 0x63D83595))
    sx = cmj_rand_float(pidx, _mul32(permutation, 0xA399D265))
    sy = cmj_rand_float(pidx, _mul32(permutation, 0x711AD6A5))
    d1 = _div(ix.to(torch.float32) + _div(iy.to(torch.float32) + sx, ny), nx)
    d2 = _div(pidx.to(torch.float32) + sy, n)
    return d1, d2


# a seed's operands: the draw plan's capacity (cmj.cu's kMaxOps)
MAX_HASH_OPERANDS = 6


def hash_combine(*vals) -> torch.Tensor:
    """Mix a tuple of at most MAX_HASH_OPERANDS uint32 tensors/ints into one
    uint32 seed (the reference's Wang-hash style finalizer over an
    FNV-ish accumulator). An all-int call stays a host value."""
    if len(vals) > MAX_HASH_OPERANDS:
        raise ValueError(f"hash_combine: at most {MAX_HASH_OPERANDS} "
                         f"operands, got {len(vals)}")
    _on_cpu("hash_combine", vals)  # raises for two devices
    # Python ints stay Python ints (scalar operands of the tensor ops): a
    # tensor made from one would be a host-to-device copy, which waits
    h = 0x9E3779B9
    for v in vals:
        v = u32(v) if isinstance(v, torch.Tensor) else int(v) & MASK32
        h = h ^ ((v + 0x9E3779B9 + ((h << 6) & MASK32) + (h >> 2)) & MASK32)
        h = (h ^ 61) ^ (h >> 16)
        h = (h + ((h << 3) & MASK32)) & MASK32
        h = h ^ (h >> 4)
        h = _mul32(h, 0x27D4EB2D)
        h = h ^ (h >> 15)
    return h if isinstance(h, torch.Tensor) else u32(h)


# ---------------------------------------------------------------------------
# The sample streams' kernel (csrc/cmj.cu): its operands and its launch
# ---------------------------------------------------------------------------

_KINDS = {torch.int32: 1, torch.int64: 2}  # cmj.cu's operand kinds (0: imm)


class _Operand(ctypes.Structure):
    """One uint32 operand of the kernel, as cmj.cu's ``Operand``: a tensor
    (its low 32 bits; stride 0 for a 0-d tensor) or an immediate."""

    _fields_ = [("ptr", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("stride", ctypes.c_int), ("imm", ctypes.c_uint32)]


def _operand(name, v) -> _Operand:
    if not isinstance(v, torch.Tensor):
        return _Operand(None, 0, 0, int(v) & MASK32)
    if v.dtype not in _KINDS:
        raise ValueError(f"{name}: int32 or int64 operands expected, got "
                         f"{v.dtype}")
    return _Operand(v.data_ptr(), _KINDS[v.dtype], 1 if v.dim() else 0, 0)


def _lanes(name, vals):
    """(``vals`` with each tensor made contiguous, the lanes' shape) for a
    launch: every tensor with a dimension has the lanes' shape, a 0-d
    tensor serves every lane."""
    vals = [v.contiguous() if isinstance(v, torch.Tensor) else v
            for v in vals]
    shapes = {tuple(v.shape) for v in vals
              if isinstance(v, torch.Tensor) and v.dim()}
    if len(shapes) > 1:
        raise ValueError(f"{name}: tensor operands of different shapes "
                         f"{sorted(shapes)}")
    shape = shapes.pop() if shapes else ()
    if int(np.prod(shape)) >= 2**31:
        raise ValueError(f"{name}: at most 2^31 - 1 lanes")
    return vals, shape


@cuda_lib.counted
def cmj(dev, *args) -> None:
    """Launch ``rt_cmj_draws`` (csrc/cmj.cu) on ``dev``'s current stream and
    count it: the launch count of the sample streams' kernel."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_lib.check(cuda_lib.library().rt_cmj_draws(*args, stream),
                   "rt_cmj_draws")
    cuda_lib.count_launch(cmj, dev)


# ---------------------------------------------------------------------------
# Draw sets: the seeds and samples of one bounce, of the camera or of a
# direct-lighting pass in one launch (csrc/cmj.cu cmj_draws_kernel)
# ---------------------------------------------------------------------------

# seed operands that are the lane's own values (anything else: an int)
LANE_OPERANDS = ("px", "py", "si")
# cmj.cu's plan capacity (kMaxSeeds, kMaxDraws): the plan and the other
# parameters of one launch fit the classic 4 KB of kernel parameters; a
# larger set is split into several launches
MAX_PLAN_SEEDS = 8
MAX_PLAN_DRAWS = 64


class Draw(NamedTuple):
    """One draw of a set: the seed ``hash_combine(*seed)`` (each operand
    one of ``LANE_OPERANDS`` or an int) and its CMJ sample of the index
    ``si * index_mul + index_add``: the 1-D sample of an ``nx`` pattern
    (``ny`` 0; one output row) or the 2-D sample of an ``nx`` x ``ny``
    pattern (two rows). ``index_mul`` 0 is the immediate index
    ``index_add``."""

    seed: tuple
    nx: int
    ny: int = 0
    index_mul: int = 1
    index_add: int = 0


def draw_rows(plan) -> list:
    """Each draw's first output row of ``cmj_draws`` in plan order."""
    rows, r = [], 0
    for dr in plan:
        rows.append(r)
        r += 2 if dr.ny else 1
    return rows


def cmj_draws_plain(plan, px, py, si) -> torch.Tensor:
    """The draw set ``plan`` (a sequence of ``Draw``) at the lanes (px, py,
    si): [n_out, *lanes] float32, each draw's rows in plan order, through
    the single draws (each distinct seed hashed once)."""
    lanes = dict(zip(LANE_OPERANDS, (px, py, si)))
    seeds, rows = {}, []
    for dr in plan:
        h = seeds.get(dr.seed)
        if h is None:
            h = seeds[dr.seed] = hash_combine(*(
                lanes[v] if isinstance(v, str) else v for v in dr.seed))
        if dr.ny:
            rows += cmj_sample_2d(si, dr.nx, dr.ny, h, dr.index_mul,
                                  dr.index_add)
        else:
            rows.append(cmj_sample_1d(si, dr.nx, h, dr.index_mul,
                                      dr.index_add))
    return torch.stack(rows)


def magic_divisor(d: int) -> tuple:
    """(d, m, l) of a divisor d in [1, 2^32): l = ceil(log2 d), m =
    floor(2^32 (2^l - d) / d) + 1 < 2^32, so that with t = umulhi(n, m),
    (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0) is floor(n / d) for
    every uint32 n (Granlund & Montgomery 1994, Theorem 4.1)."""
    if not 1 <= d <= MASK32:
        raise ValueError(f"divisor {d} out of [1, 2^32)")
    l = (d - 1).bit_length()
    return d, ((1 << 32) * ((1 << l) - d)) // d + 1, l


class _DrawDiv(ctypes.Structure):
    _fields_ = [("d", ctypes.c_uint32), ("m", ctypes.c_uint32),
                ("l", ctypes.c_uint32)]


class _DrawSpec(ctypes.Structure):
    _fields_ = [("num", _DrawDiv), ("nx", _DrawDiv), ("ny", _DrawDiv),
                ("mul", ctypes.c_uint32), ("add", ctypes.c_uint32),
                ("row", ctypes.c_int)]


class _DrawSeed(ctypes.Structure):
    _fields_ = [("imm", ctypes.c_uint32 * MAX_HASH_OPERANDS),
                ("src", ctypes.c_uint32), ("n_ops", ctypes.c_int),
                ("draw0", ctypes.c_int), ("n_draws", ctypes.c_int)]


class _DrawPlan(ctypes.Structure):
    """cmj.cu's ``DrawPlan``: seeds, their draws grouped by seed."""

    _fields_ = [("seed", _DrawSeed * MAX_PLAN_SEEDS),
                ("draw", _DrawSpec * MAX_PLAN_DRAWS),
                ("n_seeds", ctypes.c_int)]


def _check_draw(dr: Draw) -> None:
    if not isinstance(dr, Draw):
        raise TypeError(f"cmj_draws: a Draw expected, got {dr!r}")
    if dr.nx < 1 or dr.ny < 0 or dr.nx * max(dr.ny, 1) > MASK32:
        raise ValueError(f"cmj_draws: pattern {dr.nx} x {dr.ny} out of "
                         "range")
    if len(dr.seed) > MAX_HASH_OPERANDS:
        raise ValueError(f"cmj_draws: at most {MAX_HASH_OPERANDS} seed "
                         f"operands, got {len(dr.seed)}")
    for v in dr.seed:
        if isinstance(v, str) and v not in LANE_OPERANDS:
            raise ValueError(f"cmj_draws: seed operand {v!r} is neither an "
                             f"int nor one of {LANE_OPERANDS}")


@functools.lru_cache(maxsize=256)
def _encode(plan: tuple) -> tuple:
    """(the launches' ``_DrawPlan``s, output rows) of a draw set: its draws
    grouped by seed, a launch holding at most MAX_PLAN_SEEDS seeds and
    MAX_PLAN_DRAWS draws (a seed with more draws than fit is repeated in
    the next launch)."""
    for dr in plan:
        _check_draw(dr)
    rows = draw_rows(plan)
    by_seed = {}
    for dr, row in zip(plan, rows):
        by_seed.setdefault(dr.seed, []).append((dr, row))
    launches, cur, used = [], None, MAX_PLAN_DRAWS
    for seed, draws in by_seed.items():
        while draws:
            if used == MAX_PLAN_DRAWS or cur.n_seeds == MAX_PLAN_SEEDS:
                cur, used = _DrawPlan(), 0
                launches.append(cur)
            take, draws = (draws[:MAX_PLAN_DRAWS - used],
                           draws[MAX_PLAN_DRAWS - used:])
            sd = cur.seed[cur.n_seeds]
            cur.n_seeds += 1
            sd.n_ops, sd.draw0, sd.n_draws = len(seed), used, len(take)
            for j, v in enumerate(seed):
                if isinstance(v, str):
                    sd.src |= (1 + LANE_OPERANDS.index(v)) << (2 * j)
                else:
                    sd.imm[j] = int(v) & MASK32
            for dr, row in take:
                spec = cur.draw[used]
                used += 1
                spec.nx = _DrawDiv(*magic_divisor(dr.nx))
                spec.num = _DrawDiv(*magic_divisor(dr.nx * max(dr.ny, 1)))
                if dr.ny:
                    spec.ny = _DrawDiv(*magic_divisor(dr.ny))
                spec.mul = dr.index_mul & MASK32
                spec.add = dr.index_add & MASK32
                spec.row = row
    return tuple(launches), sum(2 if dr.ny else 1 for dr in plan)


def cmj_draws(plan, px, py, si) -> torch.Tensor:
    """Kernel wrapper of :func:`cmj_draws_plain`: the draw set in one
    launch (more where it outgrows a launch's plan), the lanes' px, py and
    si (int32 or int64 tensors of one shape, or 0-d) read once each."""
    plan = tuple(plan)
    if _on_cpu("cmj_draws", (px, py, si)):
        for dr in plan:
            _check_draw(dr)
        return cmj_draws_plain(plan, px, py, si)
    launches, n_rows = _encode(plan)
    vals, shape = _lanes("cmj_draws", (px, py, si))
    ops = [_operand("cmj_draws", v) for v in vals]
    dev = next(v.device for v in vals if isinstance(v, torch.Tensor))
    out = torch.empty((n_rows, *shape), dtype=torch.float32, device=dev)
    n = int(np.prod(shape))
    if n:
        _check_plan_layout()
        for p in launches:
            cmj(dev, ctypes.addressof(p),
                *(ctypes.addressof(o) for o in ops), out.data_ptr(), n)
    return out


@functools.lru_cache(maxsize=None)
def _check_plan_layout() -> None:
    """The plan's ctypes layout is the kernel's (once per process)."""
    size = cuda_lib.library().rt_cmj_plan_bytes()
    if size != ctypes.sizeof(_DrawPlan):
        raise RuntimeError(f"cmj_draws: DrawPlan is {size} bytes in cmj.cu, "
                           f"{ctypes.sizeof(_DrawPlan)} here")


# Purpose salts (same values and meaning as the reference's table).
PURPOSE_SUBPIXEL = 0x51BD0010
PURPOSE_LENS = 0x51BD0020
PURPOSE_TIME = 0x51BD0030
PURPOSE_BOUNCE = 0x51BD0040
PURPOSE_LIGHT_SELECT = 0x51BD0050
PURPOSE_LIGHT_ELEMENT = 0x51BD0060
PURPOSE_LIGHT = 0x51BD0070
PURPOSE_BRDF = 0x51BD0080
