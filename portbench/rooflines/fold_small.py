"""The work of the tiny-mesh fold, ``fold_small_kernel``
(``rayito_tpu_torch/csrc/fold_small.cu``), from the program's counters of
one render (``fold_small.tests.closest``, ``fold_small.tests.any``,
``fold_small.links``, ``fold_small.lanes.closest``,
``fold_small.lanes.any``) and the cell's configuration.

Operations: the lane instructions the warps must issue, counted from the
kernel's SASS (``chip_smoke.py``'s ``FOLD_INSNS`` and ``XF_FLOPS``): a
lane-triangle test's float instructions and loads, 336 for four tests on a
closest-hit query and 332 on an any-hit one; a link of a transform chain
at one instruction per flop, 69, and 47 more where a slot has more than
one key (the key pair's lerps and the normalised nlerp). Integer, address
and control work is left out, so the bound stays a lower bound. The rate:
132 SMs x 4 schedulers x 32 lanes a clock at 1,980 MHz (33.4 T lane
instructions a second; NVIDIA's Hopper white paper).

Bytes: each launch lane reads its ray (origin, direction), tmax, its time
where the scene moves and the running best once, and writes the merged
best once. The running best of a closest-hit query is t, prim, beta and
gamma (4 B each) and the winner's rotation (16 B) where the scene moves;
of an any-hit query one occlusion byte. The mesh rows staged per block
(under 4 KB) are left out. The lanes of each kind are the program's
counters ``fold_small.lanes.closest`` and ``fold_small.lanes.any``.
"""

from __future__ import annotations

PEAK_ISSUE = 132 * 4 * 32 * 1.98e9  # lane instructions a second
PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet
KERNEL = "fold_small_kernel"
FOLD_INSNS = {"closest": 336 / 4, "any": 332 / 4}
XF_FLOPS = {"link": 69, "keyed": 47}


def keyed(config: dict) -> bool:
    """Whether some transform slot has more than one key."""
    return any(len(s["transform"]["times"]) > 1 for s in config["shapes"]
               if s.get("transform"))


def instructions(counters: dict, is_keyed: bool) -> float:
    """Lane instructions the counted tests and links issue at least."""
    link = XF_FLOPS["link"] + XF_FLOPS["keyed"] * is_keyed
    return (counters.get("fold_small.tests.closest", 0) * FOLD_INSNS["closest"]
            + counters.get("fold_small.tests.any", 0) * FOLD_INSNS["any"]
            + counters.get("fold_small.links", 0) * link)


def lane_bytes(kind: str, motion: bool) -> int:
    """Bytes one launch lane reads and writes once."""
    ray = 6 * 4 + 4 + (4 if motion else 0)  # o, d, tmax, time
    if kind == "closest":
        best = 4 * 4 + (16 if motion else 0)
        return ray + 2 * best
    if kind == "any":
        return ray + 2
    raise ValueError(f"not a query kind: {kind}")


def nbytes(counters: dict, motion: bool) -> float:
    """Bytes of the counted launches, each lane's once."""
    return sum(counters.get(f"fold_small.lanes.{kind}", 0)
               * lane_bytes(kind, motion) for kind in ("closest", "any"))


def least_seconds(counters: dict, config: dict, motion: bool) -> float:
    """The least time of the counted work: the larger of its instructions
    at the issue rate and its bytes at the memory bandwidth."""
    return max(instructions(counters, keyed(config)) / PEAK_ISSUE,
               nbytes(counters, motion) / PEAK_BYTES_PER_S)
