"""Geometry tables for the traversal kernels (counterpart of
``rayito_tpu/accel/kernel_tables.py``; the numpy builders are the
reference's, so the tables are bit-identical).

  * triangles are grouped into clusters of KTRI = 128 consecutive triangles
    of the global BVH-DFS order; each cluster is one [KCOMP=16, 128] block
    whose rows 0-8 are v0.xyz, e1.xyz, e2.xyz (Möller-Trumbore rows);
  * ``build_bw_rows`` gives the same layout with Baldwin-Weber plane and
    barycentric rows (closest-hit launches);
  * cluster AABBs are an [8, C_pad] table (rows 0-5 = min.xyz / max.xyz,
    lanes padded to 128 with never-hit boxes);
  * the tri table is padded to whole KSC=8-cluster groups with all-zero
    (degenerate, never-hit) clusters;
  * ``build_slice_boxes`` gives, per cluster, the padded box of each
    32-lane slice (port-only: the fold's warp cull, ``csrc/fold.cuh``).

All static meshes merge into one world-space table, so one launch
traverses the scene's triangles. The MXU weight table of the reference is a
TPU-only option and is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KTRI = 128  # triangles per kernel cluster
KSC = 8  # tri-table alignment group
KCOMP = 16  # rows per cluster block (9 MT / 12 BW used)

INF = np.float32(np.inf)

# A degenerate far-away point box: near == far == huge, which
# max(near, tmin) > min(far, tmax) rejects (an inverted infinite box would
# hit every ray).
NEVER_HIT = np.float32(1e30)

SLICE = 32  # lanes of a slice: one warp's tests of a cluster at b = 128
N_SLICES = KTRI // SLICE
# a slice box's pad: of its largest extent, and of its largest |coordinate|
SLICE_PAD_EXTENT = 2.0**-8
SLICE_PAD_COORD = 2.0**-14


@dataclasses.dataclass
class KernelTables:
    """Host-side tables for one launch domain."""

    tri: np.ndarray  # [C, KCOMP, 128] f32: v0/e1/e2 component rows
    cl_box: np.ndarray  # [8, C_pad] f32
    tri_base: np.ndarray  # [C] i32 global id of each cluster's lane 0
    # piecewise-affine form of tri_base: ((cl_start, tri0), ...)
    seg: tuple
    n_clusters: int


def _box_table(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """[K, 3]/[K, 3] -> [8, K_pad] with lanes padded by never-hit boxes;
    non-finite inputs (empty clusters) are replaced too."""
    k = lo.shape[0]
    k_pad = max(128, -(-k // 128) * 128)
    out = np.full((8, k_pad), NEVER_HIT, np.float32)
    out[6:8, :] = 0.0
    bad = ~np.isfinite(lo).all(1) | ~np.isfinite(hi).all(1)
    lo = np.where(bad[:, None], NEVER_HIT, lo.astype(np.float32))
    hi = np.where(bad[:, None], NEVER_HIT, hi.astype(np.float32))
    out[0:3, :k] = lo.T
    out[3:6, :k] = hi.T
    return out


def _segment_clusters(v0, v1, v2, valid, tri0):
    """One segment (a contiguous run of global triangle ids) -> fixed
    KTRI-row clusters: (tri [c, KCOMP, KTRI], cl_min, cl_max, base [c])."""
    f32 = np.float32
    t = v0.shape[0]
    v0 = np.asarray(v0, f32)
    v1 = np.asarray(v1, f32)
    v2 = np.asarray(v2, f32)
    valid = np.asarray(valid, bool)
    c = max(1, -(-t // KTRI))
    starts = np.arange(c, dtype=np.int64) * KTRI
    ends = np.minimum(starts + KTRI, t)
    lane = np.arange(KTRI, dtype=np.int64)
    idx = starts[:, None] + lane[None, :]
    lane_ok = idx < ends[:, None]
    idx = np.minimum(idx, max(t - 1, 0))
    validp = valid[idx] & lane_ok if t else np.zeros((c, KTRI), bool)
    v0p = np.where(validp[..., None], v0[idx], 0.0)
    v1p = np.where(validp[..., None], v1[idx], 0.0)
    v2p = np.where(validp[..., None], v2[idx], 0.0)
    e1 = v1p - v0p
    e2 = v2p - v0p
    tri = np.zeros((c, KCOMP, KTRI), f32)
    for comp in range(3):
        tri[:, comp + 0, :] = v0p[:, :, comp]
        tri[:, comp + 3, :] = e1[:, :, comp]
        tri[:, comp + 6, :] = e2[:, :, comp]
    lo = np.minimum(np.minimum(v0p, v1p), v2p)
    hi = np.maximum(np.maximum(v0p, v1p), v2p)
    vmask = validp[..., None]
    cl_min = np.where(vmask, lo, INF).min(1).astype(f32)
    cl_max = np.where(vmask, hi, -INF).max(1).astype(f32)
    return tri, cl_min, cl_max, tri0 + starts


def build_kernel_tables_multi(segments) -> KernelTables:
    """One launch domain from many segments (v0, v1, v2, valid, tri0): the
    triangles of each segment in global order, padding rows marked
    invalid. tri_base records every cluster's global lane-0 id."""
    f32 = np.float32
    parts = [_segment_clusters(*seg[:5]) for seg in segments]
    seg_table = []
    off = 0
    for p, s in zip(parts, segments):
        seg_table.append((off, int(s[4])))
        off += p[0].shape[0]
    tri_c = np.concatenate([p[0] for p in parts], 0)
    cl_min = np.concatenate([p[1] for p in parts], 0)
    cl_max = np.concatenate([p[2] for p in parts], 0)
    base = np.concatenate([p[3] for p in parts], 0)
    c = tri_c.shape[0]
    cpad = -(-c // KSC) * KSC - c
    tri = np.concatenate(
        [tri_c, np.zeros((cpad, KCOMP, KTRI), f32)], 0
    ) if cpad else tri_c
    tri_base = np.concatenate([base, np.zeros(cpad, np.int64)]).astype(
        np.int32
    )
    cl_min_p = np.concatenate([cl_min, np.full((cpad, 3), INF, f32)], 0)
    cl_max_p = np.concatenate([cl_max, np.full((cpad, 3), -INF, f32)], 0)
    return KernelTables(
        tri=tri,
        cl_box=_box_table(cl_min_p, cl_max_p),
        tri_base=tri_base,
        seg=tuple(seg_table),
        n_clusters=c,
    )


def build_kernel_tables(v0, v1, v2, valid, tri0: int = 0) -> KernelTables:
    """Single-segment convenience wrapper (one mesh)."""
    return build_kernel_tables_multi([(v0, v1, v2, valid, tri0)])


def build_bw_rows(tri: np.ndarray) -> np.ndarray:
    """Per-cluster Baldwin-Weber rows in the [C, KCOMP, 128] layout:

        0-2  n.xyz       (n = e1 x e2, unnormalized)
        3    d  = n.v0                             (plane equation)
        4-6  ru.xyz = (e2 x n) / (n.n);  7   ud = -ru.v0
        8-10 rv.xyz = (n x e1) / (n.n);  11  vd = -rv.v0

    The kernel computes den = n.dir, t = (d - n.o)/den, p = o + t dir,
    u = ru.p + ud, v = rv.p + vd. Degenerate triangles get all-zero rows
    with d = -1 (t = -inf, a structural miss). Built in f64, stored f32."""
    c, kcomp, k = tri.shape
    t64 = tri.astype(np.float64)
    v0 = np.stack([t64[:, 0], t64[:, 1], t64[:, 2]], -1)
    e1 = np.stack([t64[:, 3], t64[:, 4], t64[:, 5]], -1)
    e2 = np.stack([t64[:, 6], t64[:, 7], t64[:, 8]], -1)
    n = np.cross(e1, e2)
    nn = np.einsum("cka,cka->ck", n, n)
    good = nn > 0.0
    inv = np.where(good, 1.0 / np.where(good, nn, 1.0), 0.0)[..., None]
    ru = np.cross(e2, n) * inv
    rv = np.cross(n, e1) * inv
    out = np.zeros((c, kcomp, k), np.float64)
    for ax in range(3):
        out[:, 0 + ax] = n[:, :, ax]
        out[:, 4 + ax] = ru[:, :, ax]
        out[:, 8 + ax] = rv[:, :, ax]
    out[:, 3] = np.where(good, np.einsum("cka,cka->ck", n, v0), -1.0)
    out[:, 7] = -np.einsum("cka,cka->ck", ru, v0)
    out[:, 11] = -np.einsum("cka,cka->ck", rv, v0)
    out[:, 0:3] *= good[:, None, :]
    return out.astype(np.float32)


def build_slice_boxes(tri: np.ndarray) -> np.ndarray:
    """[C, KCOMP, 128] MT rows -> [C, 4, 8] f32: per cluster and 32-lane
    slice, lo.xyz, hi.xyz and two zeros. The box is the float64 union of
    the corners v0, v0 + e1, v0 + e2 of the slice's lanes that hold a
    triangle (a nonzero row: an all-zero lane is never hit, by either
    key), widened on every side by SLICE_PAD_EXTENT of its largest extent
    plus SLICE_PAD_COORD of its largest |coordinate| and rounded outward
    to float32. A slice without a triangle gets the never-hit box.

    The pad is what lets the fold skip a slice for a ray whose slab test
    over [tmin, tmax] misses the box: a BW key's hit point lies within a
    few ulps of (|o| + |coordinates|) of its triangle, and an MT key's t
    places the ray within its relative error of the triangle, which the
    extent's share covers for rays off the triangle's plane by more than
    ~3e-5 rad. The fold widens each box once more per ray (by 2^-16 |o| and
    2 tmin |d|), which covers the slab's rounding and a self-hit at tmin,
    and bounds the slab's t by tmax only on BW rows (``csrc/fold.cuh``)."""
    f64 = np.float64
    c = tri.shape[0]
    t = tri.astype(f64).reshape(c, KCOMP, N_SLICES, SLICE)
    v0 = t[:, 0:3]
    corners = np.stack([v0, v0 + t[:, 3:6], v0 + t[:, 6:9]], 1)
    full = (tri[:, 0:9] != 0).any(1).reshape(c, 1, 1, N_SLICES, SLICE)
    lo = np.where(full, corners, np.inf).min(axis=(1, 4))  # [C, 3, 4]
    hi = np.where(full, corners, -np.inf).max(axis=(1, 4))
    real = np.isfinite(lo).all(1)  # [C, 4]
    lo = np.where(real[:, None], lo, 0.0)
    hi = np.where(real[:, None], hi, 0.0)
    pad = (SLICE_PAD_EXTENT * (hi - lo).max(1)
           + SLICE_PAD_COORD * np.maximum(abs(lo), abs(hi)).max(1))
    lo = lo - pad[:, None]
    hi = hi + pad[:, None]
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    out = np.zeros((c, N_SLICES, 8), np.float32)
    for k, v in ((0, lo32), (3, hi32)):
        out[:, :, k:k + 3] = np.where(real[:, None], v,
                                      NEVER_HIT).transpose(0, 2, 1)
    return out
