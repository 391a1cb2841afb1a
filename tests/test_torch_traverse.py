"""Port parity: render/traverse.py (plain versions of the three kernels and
the traverse() plumbing) against rayito_tpu.render.pallas_traverse run in
Pallas interpret mode on the CPU.

  * cluster masks: bit-identical words (cases of test_pallas_traverse.py's
    multi-group and gated mask tests, plus zero direction components with
    origins on box planes — the 0 * inf = NaN edge — and a dead step);
  * the cluster_masks kernel's word-root gate (``word_roots_plain``,
    ``word_live_plain``): every word the dense masks set is live, on those
    inputs, a BVH-ordered table and hypothesis-drawn on-plane rays;
  * a key tie across mask words goes to the lower cluster, as in the
    reference;
  * traverse: identical hit/miss, identical prim where both hit, t within
    the packed key's 2^-17 slack (rel < 1e-4); for any-hit launches only
    prim >= 0 is defined, and it must be identical;
  * gather_rows_t: bit-identical to transpose_rows(table[idx]).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

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


def _multi_group_case():
    """1920 clusters (two 1024-cluster pack groups in the reference)."""
    rs, box = _random_boxes(7, 1920)
    o, d = _random_rays(rs, SB)
    tmax = np.full(SB, np.inf, np.float32)
    tmax[SB // 2:] = rs.uniform(1, 50, SB - SB // 2)
    tmax[:64] = 0.0  # dead lanes
    return _soat(o, d, tmax), box, 1e-4


def _padded_case():
    """2816 padded clusters, the last 104 lane pads (1e30 point boxes),
    part of the table far away."""
    rs, box = _random_boxes(23, 2816)
    box[1, 2048:] += 400.0
    box[4, 2048:] += 400.0
    box[0:6, 2712:] = 1e30
    o, d = _random_rays(rs, SB)
    tmax = np.full(SB, np.inf, np.float32)
    tmax[:64] = 0.0
    return _soat(o, d, tmax), box, 1e-4


def _grid_boxes(nz=2):
    """8 x 8 x nz unit boxes on an even grid: [3, C] lower corners, box."""
    g = np.arange(8, dtype=np.float32)
    gx, gy, gz = np.meshgrid(g, g, g[:nz], indexing="ij")
    lo = np.stack([gx.ravel(), gy.ravel(), gz.ravel()]) * 2.0
    c = lo.shape[1]
    return lo, np.concatenate([lo, lo + 1.0, np.zeros((2, c), np.float32)])


def _nan_edge_case():
    """Axis-aligned rays (zero direction components) whose origins lie
    exactly on box planes, and a dead step (tmax = 0, tmin = 0, origins
    inside boxes); also returns (o, d, lo) for the NaN-ray check."""
    lo, box = _grid_boxes()
    c = lo.shape[1]  # 128 unit boxes on an even grid
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
    return (_soat(o, d, tmax), box, 0.0), (o, d, lo)


def test_cluster_masks_multi_group():
    """1920 clusters (two 1024-cluster pack groups in the reference)."""
    soat, box, tmin = _multi_group_case()
    ref, got = _masks_both(soat, box, tmin)
    assert got.shape == ref.shape == (SB // 128, 1920 // 32)
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


@pytest.mark.parametrize("gate", [0, 512])
def test_cluster_masks_three_groups_padded(gate):
    """2816 padded clusters, the last 104 lane pads (1e30 point boxes),
    part of the table far away; the reference's unit gate is a pure skip,
    so the ungated port matches it gated or not."""
    soat, box, tmin = _padded_case()
    ref, got = _masks_both(soat, box, tmin, gate)
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


def test_cluster_masks_nan_edge_and_dead_step():
    """Axis-aligned rays (zero direction components) whose origins lie
    exactly on box planes: (plane - o) * (1 / 0) = 0 * inf = NaN, and the
    reference's NaN-propagating min/max decide the result. Step 1 holds
    only tmax = 0 lanes with tmin = 0 and origins inside boxes: the
    reference's dead-step guard writes zero words there."""
    (soat, box, tmin), (o, d, lo) = _nan_edge_case()
    ref, got = _masks_both(soat, box, tmin)
    np.testing.assert_array_equal(got, ref)
    assert ref[:SB // 128].any() and not ref[SB // 128:].any()
    nan_rays = (d == 0) & np.isin(o, np.concatenate([lo, lo + 1.0]).ravel())
    assert nan_rays.any()


# ------------------------------------------------------ word-root gate


def _mesh_case():
    """Kernel tables of a random walk of 9,000 triangles (71 clusters in
    BVH-DFS order, three mask words with lane pads) and short rays from
    points of the walk, in walk order as a coherence sort would group
    them: most words are dead for most blocks."""
    rs = np.random.default_rng(19)
    centers = np.cumsum(rs.normal(0, 0.3, (9000, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.3, (9000, 3)).astype(np.float32)
                  for _ in range(3))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(9000, bool))
    o = centers[np.sort(rs.integers(0, 9000, SB))]
    d = rs.normal(size=(SB, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 3.0, SB).astype(np.float32)
    # diagonal rays (equal direction components) with an infinite tmax
    # slab-hit the 1e30 point boxes of the lane pads
    d[:4] = np.float32(1.0 / np.sqrt(np.float32(3.0)))
    tmax[:4] = np.inf
    return _soat(o, d, tmax), kt.cl_box, 1e-4


def _assert_gate_covers(soat, box, tmin):
    """Every word the dense plain masks set is live under the word gate;
    returns the live map."""
    masks = tv.cluster_masks_plain(torch.from_numpy(soat),
                                   torch.from_numpy(box), tmin)
    live = tv.word_live_plain(torch.from_numpy(soat),
                              tv.word_roots_plain(torch.from_numpy(box)),
                              tmin)
    assert live.shape == masks.shape
    assert not bool(((masks != 0) & ~live).any())
    return masks, live


@pytest.mark.parametrize("case", ["multi_group", "padded", "nan_edge",
                                  "mesh"])
def test_word_gate_never_skips_a_set_word(case):
    """The cluster_masks kernel tests a word's clusters only against the
    rays that hit one of its roots: on the reference's multi-group, padded,
    NaN-edge and dead-step inputs, and on a BVH-ordered table, every word
    the dense masks set is live."""
    soat, box, tmin = {"multi_group": _multi_group_case,
                       "padded": _padded_case,
                       "nan_edge": lambda: _nan_edge_case()[0],
                       "mesh": _mesh_case}[case]()
    masks, live = _assert_gate_covers(soat, box, tmin)
    assert bool((masks != 0).any())
    if case == "mesh":  # spatial neighbours: the gate skips most words
        assert float(live.float().mean()) < 0.7
        assert int(masks[0, -1]) == -1  # the pads the diagonal rays hit


def test_word_roots_are_exact_unions():
    """Rows 0-5: the min / max of the real clusters' planes; rows 6-11 the
    lane pads' 1e30 point box; all-pad and pad-free words get the 1e30
    point box for the missing group."""
    _, box, _ = _padded_case()
    roots = tv.word_roots_plain(torch.from_numpy(box)).numpy()
    real = box[0] < 1e29
    for w in (0, 63, 84, 87):
        sel = slice(32 * w, 32 * w + 32)
        r = real[sel]
        if r.any():
            np.testing.assert_array_equal(roots[0:3, w],
                                          box[0:3, sel][:, r].min(1))
            np.testing.assert_array_equal(roots[3:6, w],
                                          box[3:6, sel][:, r].max(1))
        else:
            assert (roots[0:6, w] == np.float32(1e30)).all()
        assert (roots[6:12, w] == np.float32(1e30)).all()


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 127), st.integers(0, 7),
                          st.integers(0, 2), st.booleans(),
                          st.sampled_from([0.0, 0.6]),
                          st.sampled_from([np.inf, 40.0, 3.0, 0.0])),
                min_size=1, max_size=64),
       st.sampled_from([0.0, 1e-4]))
def test_word_gate_on_plane_rays(rays, tmin):
    """Hypothesis-drawn rays with zero direction components whose origins
    lie exactly on (or just off) the planes of a grid of boxes: the root
    slab drops an axis that goes NaN, so the gate stays a superset of the
    dense masks."""
    lo, box = _grid_boxes()
    shift = np.float32([0.0, 1.0, 0.5, -0.5, 2.0, 1.5, -1.0, 3.0])
    o, d, tmax = [], [], []
    for k, s, axis, neg, tilt, tm in rays:
        o.append(lo[:, k] + shift[s])
        dv = np.zeros(3, np.float32)
        dv[axis] = -1.0 if neg else 1.0
        dv[(axis + 1) % 3] = tilt
        d.append(dv / np.linalg.norm(dv))
        tmax.append(tm)
    rep = -(-256 // len(rays))
    o = np.tile(np.float32(o), (rep, 1))[:256]
    d = np.tile(np.float32(d), (rep, 1))[:256]
    tmax = np.tile(np.float32(tmax), rep)[:256]
    rows = np.concatenate([o, d, tmax[:, None], np.zeros((256, 1))], 1)
    _assert_gate_covers(rows.astype(np.float32).reshape(1, 256, 8), box,
                        tmin)


def _tie_tables():
    """Tables where triangle 37 * 128 + j repeats triangle 5 * 128 + j at
    the same lane (clusters 5 and 37: mask words 0 and 1) for j in LANES,
    each in the plane z = 2 at its own x; every other triangle lies beyond
    z = 50. Rays from z = 0 straight up at each pair."""
    rs = np.random.default_rng(31)
    n_tri = 40 * 128
    v0, v1, v2 = (np.float32(rs.uniform(-5, 5, (n_tri, 3))) for _ in range(3))
    for v in (v0, v1, v2):
        v[:, 2] += 60.0
    o = []
    for i, j in enumerate(TIE_LANES):
        x = 10.0 * i
        for t in (5 * 128 + j, 37 * 128 + j):
            v0[t], v1[t], v2[t] = (x - 2, -2, 2), (x + 2, -2, 2), (x, 2, 2)
        o.append((x, 0.0, 0.0))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tri, bool))
    o = np.float32(o)
    d = np.tile(np.float32([0, 0, 1]), (len(o), 1))
    return kt, o, d


TIE_LANES = (0, 3, 64, 127)


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_key_tie_across_words_goes_to_the_lower_cluster(mt):
    """Equal keys in clusters 5 and 37 (mask words 0 and 1): the reference
    and the port's plain scan give the lower cluster, prim 5 * 128 + j."""
    kt, o, d = _tie_tables()
    tri = tkt.build_bw_rows(kt.tri) if mt == "bw" else kt.tri
    tmax = np.full(len(o), np.inf, np.float32)
    want = np.int32([5 * 128 + j for j in TIE_LANES])
    t_r, p_r = jpt.traverse(
        JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
        JV3(*(jnp.asarray(d[:, k]) for k in range(3))),
        jnp.asarray(tmax), _Tables(kt.cl_box, tri), 1e-4, interpret=True,
        mt_mode=mt)
    np.testing.assert_array_equal(np.asarray(p_r), want)
    n = SB
    rows = np.zeros((n, 8), np.float32)
    rows[:, 3:6] = 1.0
    rows[:len(o), 0:3], rows[:len(o), 3:6], rows[:len(o), 6] = o, d, tmax
    soat = torch.from_numpy(rows.reshape(1, n, 8))
    box = torch.from_numpy(kt.cl_box)
    masks = tv.cluster_masks(soat, box, 1e-4)
    assert int(masks[0, 0] >> 5 & 1) == 1 and int(masks[0, 1] >> 5 & 1) == 1
    t_p, p_p = tv.traverse_blocks_plain(masks, soat, torch.from_numpy(tri),
                                        1e-4, mt)
    np.testing.assert_array_equal(p_p.view(-1)[:len(o)].numpy(), want)
    np.testing.assert_array_equal(t_p.view(-1)[:len(o)].numpy(),
                                  np.asarray(t_r))


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
        slices=torch.from_numpy(tkt.build_slice_boxes(sr["tri"])),
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
