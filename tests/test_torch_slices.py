"""The fold's slice boxes (``accel/kernel_tables.py build_slice_boxes``) and
its slice test (``render/traverse.py slice_rays_plain`` /
``slice_slab_plain``, the operations of ``csrc/fold.cuh``), on the CPU:

  * the table is the float32 box, rounded outward, of each 32-lane slice's
    corners v0, v0 + e1, v0 + e2 (float64) widened by the stated pad; a
    slice with no triangle gets the never-hit box; a scene's table is
    built from its MT rows at compile, per domain;
  * the cull is conservative: on the n=64 stand-in, in stage 6's world
    space and in stage 7's rotating domain's local space, every (ray,
    triangle) pair whose key the plain BW and MT tests accept below the
    ray's initial key slab-hits its slice's box, for random rays, rays
    aimed at triangle edges and vertices, rays grazing a triangle's plane
    at 1e-2 to 1e-7 rad, rays leaving a triangle's surface, and rays whose
    tmax sits at their hit's t;
  * the slice runs the fold counts (``fold_slices_plain``) on a small
    block: the warps whose rays reach a slice, none where none does.
"""

import numpy as np
import pytest
import torch

from rayito_tpu_torch.accel import kernel_tables as tkt
from rayito_tpu_torch.ops import transform as xf
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import traverse as tv

TMIN = 1e-4


def _table_by_loops(tri):
    """build_slice_boxes written out slice by slice in Python floats."""
    c = tri.shape[0]
    out = np.zeros((c, tkt.N_SLICES, 8), np.float32)
    for ci in range(c):
        for s in range(tkt.N_SLICES):
            pts = []
            for j in range(s * tkt.SLICE, (s + 1) * tkt.SLICE):
                rows = [float(tri[ci, k, j]) for k in range(9)]
                if not any(rows):
                    continue
                v0 = rows[0:3]
                pts += [v0, [v0[k] + rows[3 + k] for k in range(3)],
                        [v0[k] + rows[6 + k] for k in range(3)]]
            if not pts:
                out[ci, s, :6] = tkt.NEVER_HIT
                continue
            lo = [min(p[k] for p in pts) for k in range(3)]
            hi = [max(p[k] for p in pts) for k in range(3)]
            pad = (tkt.SLICE_PAD_EXTENT * max(hi[k] - lo[k] for k in range(3))
                   + tkt.SLICE_PAD_COORD * max(max(abs(lo[k]), abs(hi[k]))
                                               for k in range(3)))
            for k in range(3):
                a, z = lo[k] - pad, hi[k] + pad
                a32, z32 = np.float32(a), np.float32(z)
                if float(a32) > a:
                    a32 = np.nextafter(a32, np.float32(-np.inf))
                if float(z32) < z:
                    z32 = np.nextafter(z32, np.float32(np.inf))
                out[ci, s, k], out[ci, s, 3 + k] = a32, z32
    return out


def test_slice_table_is_the_padded_union_rounded_outward():
    rs = np.random.default_rng(3)
    n = 3 * 128 + 40  # a ragged last cluster: lanes 40-127 empty
    v0, v1, v2 = (np.float32(rs.normal(0, 3, (n, 3)) + 100.0)
                  for _ in range(3))
    valid = np.ones(n, bool)
    valid[128:160] = False  # slice 0 of cluster 1 holds no triangle
    valid[300] = False
    kt = tkt.build_kernel_tables(v0, v1, v2, valid)
    got = tkt.build_slice_boxes(kt.tri)
    assert got.dtype == np.float32
    assert got.shape == (kt.tri.shape[0], 4, 8)
    np.testing.assert_array_equal(got, _table_by_loops(kt.tri))
    assert (got[1, 0, :6] == tkt.NEVER_HIT).all()
    assert (got[3, 2:, :6] == tkt.NEVER_HIT).all()
    assert (got[:, :, 6:] == 0).all()
    # every corner of a slice's triangles lies inside its box, by the pad
    t = kt.tri.astype(np.float64)
    for ci, s in ((0, 0), (2, 3), (3, 1)):
        lanes = [j for j in range(32 * s, 32 * s + 32) if t[ci, :9, j].any()]
        assert lanes
        v = t[ci, 0:3][:, lanes]
        for corner in (v, v + t[ci, 3:6][:, lanes], v + t[ci, 6:9][:, lanes]):
            assert (corner.T > got[ci, s, 0:3]).all()
            assert (corner.T < got[ci, s, 3:6]).all()


def test_a_compiled_scene_holds_a_table_per_domain(scenes):
    for sd in scenes.values():
        assert len(sd.ktab_slice) == len(sd.ktab_tri) == 1
        np.testing.assert_array_equal(
            sd.ktab_slice[0].numpy(),
            tkt.build_slice_boxes(sd.ktab_tri[0].numpy()))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Stage 6 and stage 7 on the n=64 stand-in (49,152 triangles)."""
    from rayito_tpu_torch.models import demo

    path = str(tmp_path_factory.mktemp("obj") / "bumpy64.obj")
    demo.write_bumpy_standin(path, n=64)
    return {"stage6": demo.stage6_scene(path).compile("cpu"),
            "stage7": demo.stage7_scene1(path).compile("cpu")}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _local_rays(tri, rs, n):
    """[n] rays in the domain's space and [n, 4] clusters to test each
    against: random rays, rays aimed at a vertex or an edge point of a
    triangle, rays grazing a triangle's plane, rays leaving a point of a
    triangle's surface; (o, d, tmax, clusters) as float32 numpy."""
    t = tri.astype(np.float64)
    c = tri.shape[0]
    full = np.argwhere((tri[:, 0:9] != 0).any(1))  # (cluster, lane)
    pick = full[rs.integers(0, len(full), n)]
    ci, lane = pick[:, 0], pick[:, 1]
    v0 = t[ci, 0:3, lane]
    e1, e2 = t[ci, 3:6, lane], t[ci, 6:9, lane]
    nrm = _unit(np.cross(e1, e2))
    kind = np.arange(n) % 5
    # targets: a vertex, a point of an edge, a point inside
    w = rs.uniform(0, 1, (n, 2))
    edge = np.where(rs.uniform(size=(n, 1)) < 0.5, v0 + w[:, :1] * e1,
                    v0 + e1 + w[:, :1] * (e2 - e1))
    vertex = np.where(rs.uniform(size=(n, 1)) < 0.5, v0, v0 + e2)
    inside = v0 + 0.3 * e1 + 0.3 * e2
    target = np.where((kind == 1)[:, None], vertex,
                      np.where((kind == 2)[:, None], edge, inside))
    far = target + _unit(rs.normal(size=(n, 3))) * rs.uniform(0.5, 20, (n, 1))
    d = _unit(target - far)
    o = far
    # grazing: along the plane, tilted by 1e-2 .. 1e-7 rad
    g = kind == 3
    tangent = _unit(np.cross(nrm, rs.normal(size=(n, 3))))
    ang = 10.0 ** rs.uniform(-7, -2, n)
    dg = _unit(tangent + np.tan(ang)[:, None] * nrm
               * np.sign(rs.uniform(-1, 1, (n, 1))))
    og = inside - dg * rs.uniform(0.01, 5.0, (n, 1))
    d = np.where(g[:, None], dg, d)
    o = np.where(g[:, None], og, o)
    # leaving the surface: from the inside point, random or grazing
    s = kind == 4
    ds = _unit(np.where((rs.uniform(size=n) < 0.5)[:, None],
                        rs.normal(size=(n, 3)), dg))
    d = np.where(s[:, None], ds, d)
    o = np.where(s[:, None], inside, o)
    # random rays about the mesh
    r = kind == 0
    d = np.where(r[:, None], _unit(rs.normal(size=(n, 3))), d)
    o = np.where(r[:, None], rs.normal(0, 3, (n, 3)), o)
    clusters = np.concatenate(
        [ci[:, None], rs.integers(0, c, (n, 3))], 1)
    tmax = np.full(n, np.inf)
    tmax[rs.uniform(size=n) < 0.2] = rs.uniform(0.5, 10.0)
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32), clusters)


def _accepted_outside(o, d, tmax, clusters, tables, slices):
    """(accepted, outside): the (ray, lane) pairs a key accepts below the
    ray's initial key, and those of them whose slice box the ray misses,
    summed over the BW and MT rows and over four tmax per ray: its own,
    and its nearest accepted t just below, at and just above it, where
    the key's 128-ulp bucket decides."""
    n = o.shape[0]
    oc = tuple(torch.from_numpy(o[:, k]).view(n, 1, 1) for k in range(3))
    dc = tuple(torch.from_numpy(d[:, k]).view(n, 1, 1) for k in range(3))
    lane = torch.arange(128, dtype=torch.int32)
    boxes = slices[clusters].repeat_interleave(32, dim=2)  # [n, 4, 128, 8]
    rows = torch.from_numpy(np.concatenate(
        [o, d, tmax[:, None], np.zeros((n, 1), np.float32)], 1))
    hits = outside = 0
    for mt, table in tables.items():
        rows_c = table[clusters]  # [n, 4, 16, 128]
        key = tv._keys(mt, lambda j: rows_c[:, :, j, :], oc, dc, TMIN, lane)
        t_key = torch.where(key < tv._IMAX, (key & ~127).view(torch.float32),
                            float("inf")).amin(dim=(1, 2))
        for tm in (rows[:, 6], t_key * (1 - 2.0**-22), t_key,
                   t_key * (1 + 2.0**-22)):
            r = rows.clone()
            r[:, 6] = tm
            kb = tv._pack_key(torch.clamp_max(r[:, 6], 3e38), 127)
            acc = key < kb.view(n, 1, 1)
            terms = tv.slice_rays_plain(r[:, None, None, :], TMIN, mt)
            live = tv.slice_slab_plain(terms, boxes, TMIN)
            hits += int(acc.sum())
            outside += int((acc & ~live).sum())
    return hits, outside


@pytest.mark.parametrize("name", ["stage6", "stage7"])
def test_no_accepted_key_lies_outside_its_slice_box(scenes, name):
    """Stage 6 in world space; stage 7's rays made in world space at lane
    times (aimed at the world image of local targets) and taken to the
    rotating mesh's local space as the traversal takes them."""
    sd = scenes[name]
    tri = sd.ktab_tri[0].numpy()
    tables = {"vpu": sd.ktab_tri[0], "bw": sd.ktab_mxu[0]}
    rs = np.random.default_rng(11 if name == "stage6" else 12)
    n = 3000
    o, d, tmax, clusters = _local_rays(tri, rs, n)
    if name == "stage7":
        time = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
        links = xf.lane_links(sd, sd.ktab_xf[0], time)
        v3 = lambda a: V3(*(torch.from_numpy(a[:, k].copy())  # noqa: E731
                            for k in range(3)))
        ow = xf.from_local_point_chain(links, v3(o))
        dw = xf.from_local_vector_chain(links, v3(d))
        ol, dl, _ = xf.local_ray(sd, sd.ktab_xf[0], ow, dw, time)
        o = np.stack([x.numpy() for x in (ol.x, ol.y, ol.z)], 1)
        d = np.stack([x.numpy() for x in (dl.x, dl.y, dl.z)], 1)
    hits, outside = _accepted_outside(o, d, tmax, torch.from_numpy(clusters),
                                      tables, sd.ktab_slice[0])
    assert hits > 2 * n
    assert outside == 0


def test_fold_slices_counts_the_warps_that_reach_a_slice():
    """One 128-ray block over one cluster whose four slices sit apart on
    the x axis: rays 0-31 (warp 0 at b = 128) aimed at slice 1 and every
    other ray at nothing make one run; at b = 512 the block's one warp of
    rays 0-31 runs slice 1 of the four it walks, the rest none."""
    tri = np.zeros((1, 16, 128), np.float32)
    for j in range(128):
        x = 10.0 * (j // 32) + 0.01 * (j % 32)
        tri[0, 0:3, j] = (x, 0.0, 0.0)
        tri[0, 3:6, j] = (0.5, 0.0, 0.0)
        tri[0, 6:9, j] = (0.0, 0.5, 0.0)
    slices = torch.from_numpy(tkt.build_slice_boxes(tri))
    for b in (128, 512):
        rows = np.zeros((2048, 8), np.float32)
        rows[:, 0:3] = (-100.0, 0.2, 5.0)
        rows[:, 3:6] = (0.0, 0.0, 1.0)
        rows[:, 6] = np.inf
        rows[:32, 0:3] = (10.1, 0.2, 5.0)
        rows[:32, 3:6] = (0.0, 0.0, -1.0)
        soat = torch.from_numpy(rows.reshape(1, 2048, 8))
        masks = torch.zeros((2048 // b, 1), dtype=torch.int32)
        masks[0, 0] = 1
        for mt in ("bw", "vpu"):
            masks[:, 0] = 0
            masks[0, 0] = 1
            assert int(tv.fold_slices_plain(masks, soat, slices, TMIN, mt,
                                            b=b)) == 1
            masks[:, 0] = 1  # the other blocks' rays reach no slice
            assert int(tv.fold_slices_plain(masks, soat, slices, TMIN, mt,
                                            b=b)) == 1
