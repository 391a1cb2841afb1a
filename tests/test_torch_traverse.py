"""Port parity: render/traverse.py (plain versions of the three kernels and
the traverse() plumbing) against rayito_tpu.render.pallas_traverse run in
Pallas interpret mode on the CPU.

  * cluster masks: bit-identical words (cases of test_pallas_traverse.py's
    multi-group and gated mask tests, plus zero direction components with
    origins on box planes — the 0 * inf = NaN edge — and a dead step);
  * traverse: identical hit/miss, identical prim where both hit, t within
    the packed key's 2^-17 slack (rel < 1e-4); for any-hit launches only
    prim >= 0 is defined, and it must be identical;
  * gather_rows_t: bit-identical to transpose_rows(table[idx]).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rayito_tpu.accel import kernel_tables as jkt
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import pallas_traverse as jpt
from rayito_tpu_torch.accel import kernel_tables as tkt
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import traverse as tv

SB = 2048


def _soat(o, d, tmax):
    """[n, 3] x2 + [n] -> [n_steps, SB, 8] float32 kernel rows."""
    n = o.shape[0]
    rows = np.concatenate(
        [o, d, tmax[:, None], np.zeros((n, 1), np.float32)], axis=1
    ).astype(np.float32)
    return rows.reshape(n // SB, SB, 8)


def _masks_both(soat, box, tmin, gate=0):
    ref = np.asarray(jpt._block_masks_pallas(
        jnp.asarray(soat), jnp.asarray(box), tmin, box.shape[1] // 32, True,
        gate=gate,
    ))
    got = tv.cluster_masks(torch.from_numpy(soat), torch.from_numpy(box), tmin)
    return ref, got.numpy()


def _random_boxes(seed, c):
    rs = np.random.default_rng(seed)
    lo = rs.uniform(-20, 19, (3, c)).astype(np.float32)
    return rs, np.concatenate(
        [lo, lo + rs.uniform(0.1, 2.0, (3, c)).astype(np.float32),
         np.zeros((2, c), np.float32)], axis=0
    )


def _random_rays(rs, n, spread=25.0):
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_cluster_masks_multi_group():
    """1920 clusters (two 1024-cluster pack groups in the reference)."""
    rs, box = _random_boxes(7, 1920)
    o, d = _random_rays(rs, SB)
    tmax = np.full(SB, np.inf, np.float32)
    tmax[SB // 2:] = rs.uniform(1, 50, SB - SB // 2)
    tmax[:64] = 0.0  # dead lanes
    ref, got = _masks_both(_soat(o, d, tmax), box, 1e-4)
    assert got.shape == ref.shape == (SB // 128, 1920 // 32)
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


@pytest.mark.parametrize("gate", [0, 512])
def test_cluster_masks_three_groups_padded(gate):
    """2816 padded clusters, the last 104 lane pads (1e30 point boxes),
    part of the table far away; the reference's unit gate is a pure skip,
    so the ungated port matches it gated or not."""
    rs, box = _random_boxes(23, 2816)
    box[1, 2048:] += 400.0
    box[4, 2048:] += 400.0
    box[0:6, 2712:] = 1e30
    o, d = _random_rays(rs, SB)
    tmax = np.full(SB, np.inf, np.float32)
    tmax[:64] = 0.0
    ref, got = _masks_both(_soat(o, d, tmax), box, 1e-4, gate)
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


def test_cluster_masks_nan_edge_and_dead_step():
    """Axis-aligned rays (zero direction components) whose origins lie
    exactly on box planes: (plane - o) * (1 / 0) = 0 * inf = NaN, and the
    reference's NaN-propagating min/max decide the result. Step 1 holds
    only tmax = 0 lanes with tmin = 0 and origins inside boxes: the
    reference's dead-step guard writes zero words there."""
    g = np.arange(8, dtype=np.float32)
    gx, gy, gz = np.meshgrid(g, g, g[:2], indexing="ij")
    lo = np.stack([gx.ravel(), gy.ravel(), gz.ravel()]) * 2.0
    c = lo.shape[1]  # 128 unit boxes on an even grid
    box = np.concatenate([lo, lo + 1.0, np.zeros((2, c), np.float32)])
    rs = np.random.default_rng(3)
    n = 2 * SB
    k = rs.integers(0, c, n)
    o = (lo[:, k] + rs.integers(0, 2, (3, n))).T.astype(np.float32)
    o += rs.choice(np.float32([0.0, 0.5, -0.5]), (n, 3))  # on / off planes
    d = np.zeros((n, 3), np.float32)
    axis = rs.integers(0, 3, n)
    d[np.arange(n), axis] = rs.choice(np.float32([1.0, -1.0]), n)
    tilt = rs.random(n) < 0.3  # some rays with one zero component only
    d[tilt, (axis[tilt] + 1) % 3] = 0.6
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 40.0, np.float32)
    tmax[SB:] = 0.0
    o[SB:] = lo[:, k[SB:]].T + 0.5
    ref, got = _masks_both(_soat(o, d, tmax), box, 0.0)
    np.testing.assert_array_equal(got, ref)
    assert ref[:SB // 128].any() and not ref[SB // 128:].any()
    nan_rays = (d == 0) & np.isin(o, np.concatenate([lo, lo + 1.0]).ravel())
    assert nan_rays.any()


# ---------------------------------------------------------------- traverse


def _geometry(n_tris, seed, spread=0.3):
    rs = np.random.default_rng(seed)
    centers = np.cumsum(rs.normal(0, 0.3, (n_tris, 3)), 0).astype(np.float32)
    vs = [centers + rs.normal(0, spread, (n_tris, 3)).astype(np.float32)
          for _ in range(3)]
    return centers, vs


@pytest.fixture(scope="module")
def scene_rays():
    centers, (v0, v1, v2) = _geometry(700, seed=7)
    rs = np.random.default_rng(8)
    n = 600
    o = (centers.mean(0) + rs.normal(0, 25, (n, 3))).astype(np.float32)
    d = centers[rs.integers(0, 700, n)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    valid = np.ones(700, bool)
    valid[rs.integers(0, 700, 40)] = False
    tmax = np.full(n, np.inf, np.float32)
    tmax[n // 2:] = rs.uniform(1.0, 40.0, n - n // 2)
    tmax[-50:] = 0.0  # dead lanes
    jk = jkt.build_kernel_tables(v0, v1, v2, valid)
    tk = tkt.build_kernel_tables(v0, v1, v2, valid)
    np.testing.assert_array_equal(tk.tri, jk.tri)
    np.testing.assert_array_equal(tk.cl_box, jk.cl_box)
    return dict(o=o, d=d, tmax=tmax, tri=tk.tri, bw=tkt.build_bw_rows(tk.tri),
                box=tk.cl_box)


class _Tables:
    def __init__(self, box, tri):
        self.cl_box = jnp.asarray(box)
        self.tri = jnp.asarray(tri)


_JAX_CACHE = {}


def _jax_traverse(sr, mt, any_hit, sort_rays):
    key = (mt, any_hit, sort_rays)
    if key not in _JAX_CACHE:
        tri = sr["bw"] if mt == "bw" else sr["tri"]
        t, p = jpt.traverse(
            JV3(*(jnp.asarray(sr["o"][:, k]) for k in range(3))),
            JV3(*(jnp.asarray(sr["d"][:, k]) for k in range(3))),
            jnp.asarray(sr["tmax"]), _Tables(sr["box"], tri), 1e-4,
            interpret=True, sort_rays=sort_rays, mt_mode=mt, any_hit=any_hit,
            want_t=not any_hit,
        )
        _JAX_CACHE[key] = (None if t is None else np.asarray(t),
                           np.asarray(p))
    return _JAX_CACHE[key]


def _port_traverse(sr, mt, any_hit, sort_rays, live_prefix=True):
    tri = sr["bw"] if mt == "bw" else sr["tri"]
    t, p = tv.traverse(
        TV3(*(torch.from_numpy(sr["o"][:, k].copy()) for k in range(3))),
        TV3(*(torch.from_numpy(sr["d"][:, k].copy()) for k in range(3))),
        torch.from_numpy(sr["tmax"]), torch.from_numpy(sr["box"]),
        torch.from_numpy(tri), 1e-4, sort_rays=sort_rays,
        want_t=not any_hit, mt_mode=mt, any_hit=any_hit,
        live_prefix=live_prefix,
    )
    return (None if t is None else t.numpy()), p.numpy()


MODES = [("bw", False), ("vpu", False), ("vpu", True)]


@pytest.mark.parametrize("mt,any_hit", MODES)
@pytest.mark.parametrize("jax_sort", [False, True])
@pytest.mark.parametrize("port_sort", [False, True])
def test_traverse_matches_reference(scene_rays, mt, any_hit, jax_sort,
                                    port_sort):
    t_r, p_r = _jax_traverse(scene_rays, mt, any_hit, jax_sort)
    t_p, p_p = _port_traverse(scene_rays, mt, any_hit, port_sort)
    if any_hit:
        np.testing.assert_array_equal(p_p >= 0, p_r >= 0)
        assert (p_r >= 0).sum() > 100
        return
    np.testing.assert_array_equal(np.isfinite(t_p), np.isfinite(t_r))
    both = np.isfinite(t_r)
    assert both.sum() > 100
    np.testing.assert_array_equal(p_p[both], p_r[both])
    rel = np.abs(t_p[both] - t_r[both]) / np.maximum(t_r[both], 1e-6)
    assert rel.max() < 1e-4
    np.testing.assert_array_equal(p_p[~both], -1)


@pytest.mark.parametrize("mt,any_hit", MODES)
@pytest.mark.parametrize("variant", ["sort_off", "live_prefix_off"])
def test_traverse_sort_and_live_prefix_are_pure_scheduling(scene_rays, mt,
                                                           any_hit, variant):
    """Sorting (and the live-prefix step skip) only permute work: the
    outputs equal the unsorted launch's bit for bit."""
    t0, p0 = _port_traverse(scene_rays, mt, any_hit, True)
    kw = ({"sort_rays": False} if variant == "sort_off"
          else {"sort_rays": True, "live_prefix": False})
    t1, p1 = _port_traverse(scene_rays, mt, any_hit, **kw)
    if any_hit:
        np.testing.assert_array_equal(p1 >= 0, p0 >= 0)
    else:
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(t1.view(np.int32), t0.view(np.int32))


@pytest.mark.parametrize("k", [16, 32])
def test_gather_rows_t_matches_transpose_rows(k):
    rs = np.random.default_rng(40 + k)
    table = rs.normal(size=(3000, k)).astype(np.float32)
    idx = rs.integers(0, 3000, 1024).astype(np.int32)
    ref = np.asarray(jpt.transpose_rows(jnp.asarray(table)[idx],
                                        interpret=True))
    got = tv.gather_rows_t(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == ref.shape == (k, 1024)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
