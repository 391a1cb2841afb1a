"""Triangle padding of the global triangle order (counterpart of
``rayito_tpu/accel/clusters.py``).

The reference lays every mesh's BVH-ordered triangles out in runs padded to
a multiple of TRI_PER_CLUSTER = 48 (the cluster width of its XLA traversal
pipeline). Global triangle ids count that padding, and the kernel tables,
winner rows and prim ids all index that order, so the port keeps the same
padding to keep prim ids directly comparable. The 48-wide cluster boxes and
row tables of the XLA pipeline belong to ``render/mesh_intersect.py`` and
are not ported with this slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRI_PER_CLUSTER = 48


@dataclasses.dataclass
class MeshClusters:
    """One mesh's triangles in BVH order, padded with all-zero triangles."""

    v0: np.ndarray  # [Tp, 3]
    v1: np.ndarray
    v2: np.ndarray
    pad_mask: np.ndarray  # [Tp] True for real triangles


def build_clusters(v0: np.ndarray, v1: np.ndarray,
                   v2: np.ndarray) -> MeshClusters:
    """Pad triangles that are ALREADY in BVH-DFS order."""
    t = v0.shape[0]
    tp = max(1, -(-t // TRI_PER_CLUSTER)) * TRI_PER_CLUSTER

    def padded(a):
        tail = np.zeros((tp - t, 3), np.float32)
        return np.concatenate([np.asarray(a, np.float32), tail], 0)

    return MeshClusters(padded(v0), padded(v1), padded(v2),
                        np.arange(tp) < t)
