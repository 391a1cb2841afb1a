"""Triangle clusters of the two-level traversal (counterpart of
``rayito_tpu/accel/clusters.py``).

A mesh's BVH-ordered triangles are cut into CLUSTERS of TRI_PER_CLUSTER =
48 consecutive triangles (the last padded with all-zero triangles), each
with a box, and the clusters are grouped CLUSTERS_PER_SUPER = 16 at a time
into SUPERCLUSTERS with boxes of their own: the fixed two-level tree of
the ``traversal='xla'`` route (``render/mesh_intersect.py``). Pad boxes are
+inf / -inf, so no ray enters them. The device reads two packed row tables:
``sc_rows`` [S, 128], the 16 children's boxes of each supercluster, and
``tri_rows`` [C, 512], the 48 triangles of each cluster, components grouped
SoA within the row; pad rows are all zero.

Global triangle ids count the padding to 48, and the kernel tables,
winner rows and prim ids of both routes index that order, so prim ids stay
directly comparable with the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRI_PER_CLUSTER = 48
CLUSTERS_PER_SUPER = 16
SC_ROW_WIDTH = 128  # 6 x 16 children box floats, zero-padded
TRI_ROW_WIDTH = 512  # 9 x 48 triangle floats (SoA within the row), padded


@dataclasses.dataclass
class MeshClusters:
    """One mesh's cluster tables (triangles already in BVH order)."""

    v0: np.ndarray  # [Tp, 3] padded triangles
    v1: np.ndarray
    v2: np.ndarray
    pad_mask: np.ndarray  # [Tp] True for real triangles
    cl_min: np.ndarray  # [C, 3] (C a multiple of 16; pad boxes +inf)
    cl_max: np.ndarray  # [C, 3] (pad boxes -inf)
    sc_min: np.ndarray  # [S, 3]
    sc_max: np.ndarray  # [S, 3]
    sc_rows: np.ndarray  # [S, 128] children boxes per supercluster
    tri_rows: np.ndarray  # [C, 512] 48 triangles per cluster, SoA in row
    n_clusters: int  # C: whole superclusters
    n_supers: int  # S


def build_clusters(v0: np.ndarray, v1: np.ndarray,
                   v2: np.ndarray) -> MeshClusters:
    """Cluster triangles that are ALREADY in BVH-DFS order."""
    f32 = np.float32
    t = v0.shape[0]
    c = max(1, -(-t // TRI_PER_CLUSTER))
    tp = c * TRI_PER_CLUSTER

    def padded(a):
        tail = np.zeros((tp - t, 3), f32)
        return np.concatenate([np.asarray(a, f32), tail], 0)

    v0p, v1p, v2p = padded(v0), padded(v1), padded(v2)
    pad_mask = np.arange(tp) < t

    # the all-zero pad triangles must not grow the boxes
    valid = pad_mask.reshape(c, TRI_PER_CLUSTER, 1)
    lo = np.minimum(np.minimum(v0p, v1p), v2p).reshape(c, TRI_PER_CLUSTER, 3)
    hi = np.maximum(np.maximum(v0p, v1p), v2p).reshape(c, TRI_PER_CLUSTER, 3)
    cl_min = np.where(valid, lo, np.inf).min(1).astype(f32)
    cl_max = np.where(valid, hi, -np.inf).max(1).astype(f32)

    s = -(-c // CLUSTERS_PER_SUPER)
    cpad = s * CLUSTERS_PER_SUPER - c
    cl_min = np.concatenate([cl_min, np.full((cpad, 3), np.inf, f32)], 0)
    cl_max = np.concatenate([cl_max, np.full((cpad, 3), -np.inf, f32)], 0)
    kids_min = cl_min.reshape(s, CLUSTERS_PER_SUPER, 3)
    kids_max = cl_max.reshape(s, CLUSTERS_PER_SUPER, 3)

    sc_rows = np.zeros((s, SC_ROW_WIDTH), f32)
    for comp in range(3):
        sc_rows[:, comp * 16:(comp + 1) * 16] = kids_min[:, :, comp]
        sc_rows[:, 48 + comp * 16:48 + (comp + 1) * 16] = kids_max[:, :, comp]

    tri_rows = np.zeros((s * CLUSTERS_PER_SUPER, TRI_ROW_WIDTH), f32)
    for vi, vert in enumerate((v0p, v1p, v2p)):
        for comp in range(3):
            col = (vi * 3 + comp) * TRI_PER_CLUSTER
            tri_rows[:c, col:col + TRI_PER_CLUSTER] = vert[:, comp].reshape(
                c, TRI_PER_CLUSTER)

    return MeshClusters(
        v0=v0p, v1=v1p, v2=v2p, pad_mask=pad_mask, cl_min=cl_min,
        cl_max=cl_max, sc_min=kids_min.min(1).astype(f32),
        sc_max=kids_max.max(1).astype(f32), sc_rows=sc_rows,
        tri_rows=tri_rows, n_clusters=s * CLUSTERS_PER_SUPER, n_supers=s,
    )
