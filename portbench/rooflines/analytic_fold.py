"""The work of the analytic fold, ``analytic_fold_kernel``
(``rayito_tpu_torch/csrc/analytic_fold.cu``), from the program's counters
of one render (``analytic_fold.tests.plane``, ``.tests.sphere``,
``.tests.rect``, ``analytic_fold.lanes.closest``,
``analytic_fold.lanes.any``) and the scene's motion.

Operations: the lane instructions the warps must issue for the counted
row tests, counted from the kernel's SASS (``chip_smoke.py``'s
``AF_INSNS``): a row test's float instructions (adds, multiplies,
compares, selects, MUFU and FCHK) and loads, 36 for a plane, 65 for a
sphere and 156 for a rect, the same on a closest-hit and an any-hit
query. The counters count each test a lane ran, an any-hit lane's up to
its first hit. The links of keyed rows' transform chains, the winner's
record, integer, address and control work are left out, so the bound stays
a lower bound. The rate: 132 SMs x 4 schedulers x 32 lanes a clock at
1,980 MHz (33.4 T lane instructions a second; NVIDIA's Hopper white paper).

Bytes: each lane of a query reads its ray (origin, direction), tmax and,
where the scene moves, its time once, and writes its record once: on a
closest-hit query t, shape id, material, normal and color_mod (28 B), on
an any-hit query one occlusion byte. A chained launch's read of the
state its predecessor wrote, and its write of it again, are left out.
The lanes of each kind are the counters ``analytic_fold.lanes.closest``
and ``analytic_fold.lanes.any``.
"""

from __future__ import annotations

PEAK_ISSUE = 132 * 4 * 32 * 1.98e9  # lane instructions a second
PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet
KERNEL = "analytic_fold_kernel"
AF_INSNS = {"plane": 36, "sphere": 65, "rect": 156}


def instructions(counters: dict) -> float:
    """Lane instructions the counted row tests issue at least."""
    return sum(counters.get(f"analytic_fold.tests.{kind}", 0) * insns
               for kind, insns in AF_INSNS.items())


def lane_bytes(kind: str, motion: bool) -> int:
    """Bytes one lane of a query reads and writes once."""
    ray = 6 * 4 + 4 + (4 if motion else 0)  # o, d, tmax, time
    if kind == "closest":
        return ray + 4 * 4 + 3 * 4  # t, id, material, color_mod; normal
    if kind == "any":
        return ray + 1
    raise ValueError(f"not a query kind: {kind}")


def nbytes(counters: dict, motion: bool) -> float:
    """Bytes of the counted queries, each lane's once."""
    return sum(counters.get(f"analytic_fold.lanes.{kind}", 0)
               * lane_bytes(kind, motion) for kind in ("closest", "any"))


def least_seconds(counters: dict, motion: bool) -> float:
    """The least time of the counted work: the larger of its instructions
    at the issue rate and its bytes at the memory bandwidth."""
    return max(instructions(counters) / PEAK_ISSUE,
               nbytes(counters, motion) / PEAK_BYTES_PER_S)
