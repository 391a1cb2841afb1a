"""BVH construction on the host: the DFS primitive order that feeds the
128-triangle kernel clusters (counterpart of ``rayito_tpu/accel/bvh.py``).

Same builder as the reference (2N-1 nodes, one primitive per leaf, split on
the largest extent at the spatial midpoint, median fallback for degenerate
partitions), so the port and the reference produce the same global
triangle ids from the same mesh. The device never walks the tree; only the
primitive order is used. The native C++ builder runs when its library is
built (``utils/native.py``); the two builders may break ties differently,
and both packages follow the same rule.
"""

from __future__ import annotations

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
    return build_bvh_order(v0, v1, v2)


def build_bvh_order(v0: np.ndarray, v1: np.ndarray,
                    v2: np.ndarray) -> np.ndarray:
    """Python builder: the permutation with reordered[i] =
    original[order[i]] (iterative DFS, left child first)."""
    f32 = np.float32
    n = v0.shape[0]
    bb_min = np.minimum(np.minimum(v0.astype(f32), v1.astype(f32)),
                        v2.astype(f32))
    bb_max = np.maximum(np.maximum(v0.astype(f32), v1.astype(f32)),
                        v2.astype(f32))
    centroids = 0.5 * (bb_min + bb_max)
    order = np.arange(n)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        count = hi - lo
        if count == 1:
            continue
        idxs = order[lo:hi]
        nb_min = bb_min[idxs].min(axis=0)
        nb_max = bb_max[idxs].max(axis=0)
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
        # push right first so the left subtree is visited next
        stack.append((lo + n_left, hi))
        stack.append((lo, lo + n_left))
    return order.astype(np.int32)
