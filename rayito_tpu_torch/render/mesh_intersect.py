"""Dense fold of the tiny transformed meshes (counterpart of
``rayito_tpu/render/mesh_intersect.py``).

A transformed mesh of at most 192 triangles (``SceneData.ktab_small``: the
stage-7 cubes) would pay a whole sort, mask and traversal launch of its
own, so the renderer tests every ray against every triangle of its padded
run at once: one [N, T] Möller-Trumbore, T at most 4 x 48. The triangles
are the mesh's rows of ``tri_vert_rows`` (global ids ``tri0 + j``), the
same floats as the reference's 48-wide cluster rows; the all-zero padding
triangles never hit.

The reference counts a mesh's clusters padded to a multiple of 16, so it
sends these meshes down its two-level cluster pipeline; the pad clusters
hold only all-zero triangles, and its result is this fold's. That pipeline
serves meshes above 192 triangles only under ``traversal='xla'``, which the
port does not have: such a mesh raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import torch

from ..accel.clusters import TRI_PER_CLUSTER
from ..ops.intersect import triangle_intersect
from ..ops.vec3 import V3

BRUTE_FORCE_CLUSTERS = 4  # meshes of at most 4 x 48 triangles


def mesh_intersect_clusters(scene, mi: int, o: V3, d: V3, tmin, tmax,
                            any_hit: bool = False):
    """Nearest hit of mesh ``mi`` for its local-space rays o, d (V3 of
    [N]) below ``tmax`` ([N] or scalar). Returns (t [N], prim [N] global
    triangle id or -1, beta [N], gamma [N], overflow 0). Ties go to the
    lowest triangle; ``any_hit`` is accepted for the reference's
    signature (the fold finds the nearest hit either way)."""
    del any_hit
    tri0, count = scene.mesh_tri_ranges[mi]
    n_cl = max(1, -(-count // TRI_PER_CLUSTER))
    if n_cl > BRUTE_FORCE_CLUSTERS:
        raise NotImplementedError(
            f"mesh {mi}: {count} triangles; the two-level cluster pipeline "
            "for transformed meshes above 192 triangles (traversal='xla') "
            "is not ported"
        )
    rows = scene.tri_vert_rows[tri0:tri0 + n_cl * TRI_PER_CLUSTER]  # [T, 16]
    vert = lambda k: V3(rows[None, :, k], rows[None, :, k + 1],
                        rows[None, :, k + 2])
    n = o.x.shape[0]
    if not torch.is_tensor(tmax):  # filled on the device: no copy to wait on
        tmax = torch.full((n,), float(tmax), device=o.x.device)
    tmax = tmax.to(torch.float32).expand(n)
    t, _, beta, gamma, _ = triangle_intersect(
        o[:, None], d[:, None], tmin, tmax[:, None], vert(0), vert(3),
        vert(6))
    j = torch.argmin(t, dim=1, keepdim=True)  # the first of tied minima
    t_best = t.gather(1, j)[:, 0]
    prim = torch.where(torch.isfinite(t_best), tri0 + j[:, 0].to(torch.int32),
                       -1).to(torch.int32)
    return (t_best, prim, beta.gather(1, j)[:, 0], gamma.gather(1, j)[:, 0],
            0)
