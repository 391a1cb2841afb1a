"""BVH construction on the host: the DFS primitive order that feeds the
kernel tables and the two-level clusters (counterpart of
``rayito_tpu/accel/bvh.py``).

Same builder as the reference (2N-1 nodes, one primitive per leaf, split on
the largest extent at the spatial midpoint, median fallback for degenerate
partitions, node box the union of its primitives' boxes), so the port and
the reference produce the same global triangle ids from the same mesh. The
device never walks the tree; only the primitive order is used. The native
C++ builder runs when its library is built (``utils/native.py``); the two
builders may break ties differently, and both packages follow the same
rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def bvh_prim_order(v0: np.ndarray, v1: np.ndarray,
                   v2: np.ndarray) -> np.ndarray:
    """DFS primitive order for clustering (native builder when available)."""
    from ..utils.native import bvh_order as native_order

    if v0.shape[0] == 0:
        return np.zeros(0, np.int32)
    order = native_order(v0, v1, v2)
    if order is not None:
        return order
    return build_bvh(v0, v1, v2).prim_order


@dataclasses.dataclass
class BuiltBvh:
    """Host-side BVH: node boxes and the primitive permutation."""

    nodes_min: np.ndarray  # [2N-1, 3] float32
    nodes_max: np.ndarray  # [2N-1, 3] float32
    prim: np.ndarray  # [2N-1] i32 leaf primitive (reordered space), -1 inner
    prim_order: np.ndarray  # [N] i32: reordered[i] = original[prim_order[i]]
    depth: int


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BuiltBvh:
    """Python builder over a triangle soup: iterative DFS, left child
    first, children allocated in pairs (node 0 the root)."""
    n = v0.shape[0]
    f32, i32 = np.float32, np.int32
    if n == 0:
        return BuiltBvh(np.zeros((0, 3), f32), np.zeros((0, 3), f32),
                        np.zeros(0, i32), np.zeros(0, i32), 0)
    bb_min = np.minimum(np.minimum(v0.astype(f32), v1.astype(f32)),
                        v2.astype(f32))
    bb_max = np.maximum(np.maximum(v0.astype(f32), v1.astype(f32)),
                        v2.astype(f32))
    centroids = 0.5 * (bb_min + bb_max)
    m = 2 * n - 1
    nodes_min = np.zeros((m, 3), f32)
    nodes_max = np.zeros((m, 3), f32)
    prim = np.full(m, -1, i32)
    order = np.arange(n)
    next_free, max_depth = 1, 0
    stack = [(0, 0, n, 0)]  # (node, lo, hi, depth)
    while stack:
        node, lo, hi, depth = stack.pop()
        max_depth = max(max_depth, depth)
        idxs = order[lo:hi]
        nb_min = bb_min[idxs].min(axis=0)
        nb_max = bb_max[idxs].max(axis=0)
        nodes_min[node], nodes_max[node] = nb_min, nb_max
        count = hi - lo
        if count == 1:
            prim[node] = lo
            continue
        axis = int(np.argmax(nb_max - nb_min))
        mid = 0.5 * (nb_min[axis] + nb_max[axis])
        cvals = centroids[idxs, axis]
        mask = cvals < mid
        n_left = int(mask.sum())
        if n_left == 0 or n_left == count:
            # degenerate spatial split -> median split
            n_left = count // 2
            order[lo:hi] = idxs[np.argpartition(cvals, n_left)]
        else:
            order[lo:hi] = np.concatenate([idxs[mask], idxs[~mask]])
        child, next_free = next_free, next_free + 2
        # push right first so the left subtree is visited next
        stack.append((child + 1, lo + n_left, hi, depth + 1))
        stack.append((child, lo, lo + n_left, depth + 1))
    return BuiltBvh(nodes_min, nodes_max, prim, order.astype(i32), max_depth)
