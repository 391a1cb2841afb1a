"""Port parity: the item-list traversal (``build_items``,
``traverse_items_plain``, ``traverse(items=True)``), the streamed tables and
the lane-packed winner rows, against rayito_tpu run in Pallas interpret
mode on the CPU.

  * build_items (the wrapper, which takes the plain version for CPU
    tensors, and build_items_plain): bit for bit against ``_build_items``
    (the hand case of test_pallas_traverse.py, seeded random masks,
    overflow by total and by cap, all-zero masks, a total of exactly
    maxitems and one past it, a block of exactly cap clusters and one
    above it);
  * traverse(items=True): identical to the reference's item route (budgets
    monkeypatched to ITEMS_MAX 2048 / ITEMS_CAP 16 as its own test does) and
    to the port's scan route, bit for bit; an 8/4 budget overflows and
    returns the scan's results; a hit whose key equals the initial key is a
    miss, and NaN tmax lanes behave as in the reference;
  * streamed tables: the reference's scan kernel forced to stream
    (tri_chunk=32, three chunks) gives the port's prim;
  * packed rows: a reference scene compiled with RAYITO_PACKED_ROWS=1,
    carried across by scene_data_from_arrays, intersects as the reference;
  * the slice: the big scene on five n=8 stand-ins at 32x32, depth 3,
    traverse_items=True, within 0.5% relative RMSE of the reference's item
    route and bit-identical to the port's scan route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayito_tpu.models import demo as jdemo
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import pallas_traverse as jpt
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
from rayito_tpu_torch.accel import kernel_tables as tkt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import (
    ARRAY_FIELDS,
    DOMAIN_FIELDS,
    STATIC_FIELDS,
    scene_data_from_arrays,
)
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils.config import RenderConfig as TConfig

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
MODES = [("bw", False), ("vpu", False), ("vpu", True)]
# the main path's launches (bw_closest): closest hit 'bw', any-hit 'vpu';
# the tests that run the reference in interpret mode take these two
MAIN_MODES = [("bw", False), ("vpu", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain versions run many small tensor ops; on a loaded CPU
    torch's intra-op threads spin against each other (the streamed-table
    test took 114 s instead of 4 s beside six busy processes). One thread
    keeps the file's time steady."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------- build_items


def _build_both(masks, w, maxitems, cap):
    """The wrapper (on CPU tensors: the plain version) and the plain version
    against the reference, bit for bit on all four outputs."""
    ref = [np.asarray(x) for x in jpt._build_items(jnp.asarray(masks), w,
                                                    maxitems, cap)]
    for build in (tv.build_items, tv.build_items_plain):
        got = [x.numpy() for x in build(torch.from_numpy(masks), w,
                                        maxitems, cap)]
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
    return got


def test_build_items_hand_case():
    """The case of test_pallas_traverse.py's build test: ascending w-aligned
    runs padded with the last cluster, empty blocks unused, and the grid
    clamp on overflow by total and by cap."""
    masks = np.zeros((3, 2), np.int32)
    masks[0, 0] = 0b1011  # clusters 0, 1, 3 -> 0 1 3 3
    masks[2, 1] = 1 << 5  # cluster 37 -> four times
    items, n_steps, overflow, used = _build_both(masks, 4, 64, 8)
    assert not overflow and int(n_steps) == 2
    got = [(x >> tv.CID_BITS, x & ((1 << tv.CID_BITS) - 1)) for x in items[:8]]
    assert got == [(0, 0), (0, 1), (0, 3), (0, 3),
                   (2, 37), (2, 37), (2, 37), (2, 37)]
    assert (items[8:] == -1).all()
    np.testing.assert_array_equal(used, [True, False, True])
    dense = np.full((4, 2), -1, np.int32)  # 64 clusters in every block
    _, n_steps, overflow, _ = _build_both(dense, 4, 128, 64)
    assert bool(overflow) and int(n_steps) == 128 // 4
    _, _, overflow, _ = _build_both(dense, 4, 1024, 8)
    assert bool(overflow)


def _random_masks(seed):
    """Seeded random [24, 4] mask words with empty blocks, dense blocks and
    -1 words (bit 31; block 3 lists every cluster), and each block's
    count."""
    rs = np.random.default_rng(seed)
    bits = rs.random((24, 4, 32)) < rs.uniform(0.05, 0.6, (24, 1, 1))
    bits[rs.random(24) < 0.25] = False
    bits[3] = True
    words = (bits.astype(np.int64) << np.arange(32)).sum(-1)
    masks = np.where(words >= 2**31, words - 2**32, words).astype(np.int32)
    return masks, bits.sum((1, 2))


# (w, maxitems, cap) over one [24, 4] mask shape: fits, tight fit, overflow
# by total, overflow by cap, w = 1 and w = 8
BUDGETS = [(4, 3072, 128), (3, 1400, 100), (4, 300, 128), (4, 3072, 20),
           (1, 3072, 128), (8, 3072, 128)]


@pytest.mark.parametrize("w,maxitems,cap", BUDGETS)
def test_build_items_random_masks(w, maxitems, cap):
    """Seeded random masks with empty blocks, dense blocks and -1 words
    (bit 31), under budgets that fit or overflow by total or by cap."""
    masks, counts = _random_masks(100 + w + maxitems + cap)
    total = int((-(-counts // w) * w).sum())
    overflow = total > maxitems or counts.max() > cap
    _, n_steps, flag, _ = _build_both(masks, w, maxitems, cap)
    assert bool(flag) == overflow
    assert int(n_steps) == min(total, maxitems) // w


# (case, w): budgets at the edges of the overflow test, set from the masks
EDGES = [("zero", 4), ("total_is_max", 4), ("total_past_max", 4),
         ("count_is_cap", 4), ("count_past_cap", 4), ("total_is_max", 1),
         ("count_is_cap", 8)]


@pytest.mark.parametrize("case,w", EDGES)
def test_build_items_edge_budgets(case, w):
    """All-zero masks (no group), a total of exactly maxitems and one past
    it, a block of exactly cap clusters and one above it, w = 1 and 8."""
    masks, counts = _random_masks(7 + w)
    if case == "zero":
        masks[:] = 0
        counts[:] = 0
    total = int((-(-counts // w) * w).sum())
    maxitems, cap = max(total, 1), int(max(counts.max(), 1))
    if case == "total_past_max":
        maxitems = total - 1
    if case == "count_past_cap":
        cap -= 1
    items, n_steps, flag, used = _build_both(masks, w, maxitems, cap)
    assert bool(flag) == (case in ("total_past_max", "count_past_cap"))
    assert int(n_steps) == min(total, maxitems) // w
    assert int(used.sum()) == int((counts > 0).sum())
    if case == "zero":
        assert int(n_steps) == 0 and (items == -1).all()


def test_build_items_on_the_cpu_is_the_plain_version():
    """CPU tensors take the plain version: the same outputs, no launch."""
    masks = torch.from_numpy(_random_masks(3)[0])
    before = tv.build_items.launches
    got = tv.build_items(masks, 4, 3072, 128)
    ref = tv.build_items_plain(masks, 4, 3072, 128)
    assert tv.build_items.launches == before
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


# ---------------------------------------------------------------- traverse


@pytest.fixture(scope="module")
def rays_scene():
    """The setting of test_pallas_traverse.py's item test: 500 triangles,
    400 rays aimed at them, the last 60 dead (empty item blocks)."""
    rs = np.random.default_rng(21)
    centers = np.cumsum(rs.normal(0, 0.3, (500, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.3, (500, 3)).astype(np.float32)
                  for _ in range(3))
    n = 400
    o = (centers.mean(0) + rs.normal(0, 20, (n, 3))).astype(np.float32)
    d = (centers[rs.integers(0, 500, n)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    tmax[n // 2:] = rs.uniform(1.0, 40.0, n - n // 2)
    tmax[-60:] = 0.0
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(500, bool))
    return dict(o=o, d=d, tmax=tmax, box=kt.cl_box, vpu=kt.tri,
                bw=tkt.build_bw_rows(kt.tri))


class _Tables:
    def __init__(self, box, tri):
        self.cl_box = jnp.asarray(box)
        self.tri = jnp.asarray(tri)


def _jax(s, mt, any_hit, sort_rays, items, **kw):
    t, p = jpt.traverse(
        JV3(*(jnp.asarray(s["o"][:, k]) for k in range(3))),
        JV3(*(jnp.asarray(s["d"][:, k]) for k in range(3))),
        jnp.asarray(s["tmax"]), _Tables(s["box"], s[mt]), 1e-4,
        interpret=True, sort_rays=sort_rays, mt_mode=mt, any_hit=any_hit,
        want_t=not any_hit, items=items, **kw,
    )
    return (None if t is None else np.asarray(t)), np.asarray(p)


def _port(s, mt, any_hit, sort_rays, items, tri=None, **kw):
    t, p = tv.traverse(
        TV3(*(torch.from_numpy(s["o"][:, k].copy()) for k in range(3))),
        TV3(*(torch.from_numpy(s["d"][:, k].copy()) for k in range(3))),
        torch.from_numpy(s["tmax"]), torch.from_numpy(s["box"]),
        torch.from_numpy(s[mt] if tri is None else tri), 1e-4,
        slices=torch.from_numpy(tkt.build_slice_boxes(
            s["vpu"] if tri is None else tri)),
        sort_rays=sort_rays, want_t=not any_hit, mt_mode=mt,
        any_hit=any_hit, items=items, **kw,
    )
    return (None if t is None else t.numpy()), p.numpy()


def _assert_ref(got, ref, any_hit):
    """Against the reference: prim bit for bit; t (closest hit) within the
    packed key's 2^-17 slack, since XLA:CPU rounds some ray-triangle t
    differently (test_torch_traverse.py states the same rule)."""
    (t_g, p_g), (t_r, p_r) = got, ref
    if any_hit:
        np.testing.assert_array_equal(p_g >= 0, p_r >= 0)
        return
    np.testing.assert_array_equal(p_g, p_r)
    np.testing.assert_array_equal(np.isfinite(t_g), np.isfinite(t_r))
    hit = np.isfinite(t_r)
    rel = np.abs(t_g[hit] - t_r[hit]) / np.maximum(t_r[hit], 1e-6)
    assert rel.max(initial=0.0) < 1e-4


def _assert_same(a, b, any_hit):
    (t_a, p_a), (t_b, p_b) = a, b
    if any_hit:
        np.testing.assert_array_equal(p_a >= 0, p_b >= 0)
        return
    np.testing.assert_array_equal(p_a, p_b)
    np.testing.assert_array_equal(t_a.view(np.int32), t_b.view(np.int32))


SMALL = dict(items_max=2048, items_cap=16)


@pytest.mark.parametrize("mt,any_hit", MAIN_MODES)
@pytest.mark.parametrize("sort_rays", [False, True])
def test_items_route_matches_reference(rays_scene, monkeypatch, mt, any_hit,
                                       sort_rays):
    monkeypatch.setattr(jpt, "ITEMS_MAX", 2048)
    monkeypatch.setattr(jpt, "ITEMS_CAP", 16)
    try:
        ref = _jax(rays_scene, mt, any_hit, sort_rays, True)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got = _port(rays_scene, mt, any_hit, sort_rays, True, **SMALL)
    assert (ref[1] >= 0).sum() > 100
    _assert_ref(got, ref, any_hit)


@pytest.mark.parametrize("mt,any_hit", MODES)
@pytest.mark.parametrize("sort_rays", [False, True])
def test_items_route_matches_scan_route(rays_scene, mt, any_hit, sort_rays):
    scan = _port(rays_scene, mt, any_hit, sort_rays, False)
    got = _port(rays_scene, mt, any_hit, sort_rays, True, **SMALL)
    _assert_same(got, scan, any_hit)
    masks = tv.cluster_masks(
        tv.prepare_rays(
            TV3(*(torch.from_numpy(rays_scene["o"][:, k].copy())
                  for k in range(3))),
            TV3(*(torch.from_numpy(rays_scene["d"][:, k].copy())
                  for k in range(3))),
            torch.from_numpy(rays_scene["tmax"]),
            torch.from_numpy(rays_scene["box"]), 1e-4, sort_rays)[0],
        torch.from_numpy(rays_scene["box"]), 1e-4)
    _, _, overflow, used = tv.build_items(masks, 4, 2048, 16)
    assert not bool(overflow) and not bool(used.all())  # dead blocks


@pytest.mark.parametrize("mt,any_hit", MODES)
def test_items_overflow_returns_scan_results(rays_scene, mt, any_hit):
    """An 8-item budget (cap 4) overflows every real launch here: the
    device-side flag hands the launch to the scan."""
    scan = _port(rays_scene, mt, any_hit, False, False)
    got = _port(rays_scene, mt, any_hit, False, True, items_max=8,
                items_cap=4)
    assert (scan[1] >= 0).sum() > 100
    _assert_same(got, scan, any_hit)


def _tie_scene(with_nan):
    """Two clusters: lane 127 of cluster 0 spans the ray at x = 0 and lane 5
    of cluster 1 the ray at x = 20, both in the plane z = 2, where both
    triangle tests give t = 2 exactly. ``with_nan`` adds NaN tmax lanes of
    either sign to the launch."""
    v0 = np.zeros((256, 3), np.float32)
    v1, v2 = v0.copy(), v0.copy()
    valid = np.zeros(256, bool)
    for i, x in ((127, 0.0), (133, 20.0)):
        v0[i], v1[i], v2[i] = (x - 4, -4, 2), (x + 4, -4, 2), (x, 4, 2)
        valid[i] = True
    kt = tkt.build_kernel_tables(v0, v1, v2, valid)
    two = np.float32(2.0).view(np.int32)
    tmax = [np.inf, 2.0, (two + 128).view(np.float32), 2.0, 0.0]
    xs = [0, 0, 0, 20, 0]
    if with_nan:
        nan = np.float32(np.nan)
        tmax += [nan, -nan, nan]
        xs += [0, 0, 20]
    n = len(xs)
    o = np.stack([np.float32(xs), np.zeros(n), np.zeros(n)], 1)
    return dict(o=o.astype(np.float32),
                d=np.tile(np.float32([0, 0, 1]), (n, 1)),
                tmax=np.array(tmax, np.float32), box=kt.cl_box, vpu=kt.tri,
                bw=tkt.build_bw_rows(kt.tri))


@pytest.mark.parametrize("mt,any_hit", MAIN_MODES)
def test_items_tie_with_initial_key_is_a_miss(mt, any_hit):
    """tmax = t puts the initial key pack(min(tmax, 3e38), 127) equal to the
    lane-127 hit's key: a miss on every route. The lane-5 hit at the same
    t, and a tmax one key bucket above, are hits. A NaN tmax lane makes its
    whole step dead (the reference's step guard takes a NaN-propagating
    max of tmax), on every route as in the reference."""
    for with_nan in (False, True):
        s = _tie_scene(with_nan)
        ref = _jax(s, mt, any_hit, False, True)
        for sort_rays in (False, True):
            scan = _port(s, mt, any_hit, sort_rays, False)
            items = _port(s, mt, any_hit, sort_rays, True)
            _assert_ref(items, ref, any_hit)
            _assert_same(items, scan, any_hit)
        hit = items[1] >= 0
        if with_nan:
            assert not hit.any()
            continue
        np.testing.assert_array_equal(hit, [True, False, True, True, False])
        if not any_hit:
            assert (items[1][[0, 2]] == 127).all() and items[1][3] == 128 + 5
            assert (items[0][[0, 2, 3]] == 2.0).all()
    jax.clear_caches()


def test_streamed_table_matches_port_traverse(monkeypatch):
    """The reference's scan kernel streaming a 71-cluster table in chunks of
    32 (three chunks; tri_chunk as test_pallas_scene.py forces it) gives
    the port's prim on both of the port's routes: streaming is a VMEM
    schedule, and the port reads the table from global memory whole."""
    rs = np.random.default_rng(77)
    n_tri = 9000
    centers = np.cumsum(rs.normal(0, 0.3, (n_tri, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.3, (n_tri, 3)).astype(np.float32)
                  for _ in range(3))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tri, bool))
    assert kt.tri.shape[0] > 2 * 32
    n = 512
    o = (centers.mean(0) + rs.normal(0, 30, (n, 3))).astype(np.float32)
    d = (centers[rs.integers(0, n_tri, n)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = dict(o=o, d=d, tmax=np.full(n, np.inf, np.float32), box=kt.cl_box,
             vpu=kt.tri, bw=tkt.build_bw_rows(kt.tri))
    for mt in ("bw", "vpu"):
        ref = _jax(s, mt, False, False, False, tri_chunk=32)
        whole = _jax(s, mt, False, False, False, tri_chunk=512)
        np.testing.assert_array_equal(ref[1], whole[1])
        assert (ref[1] >= 0).sum() > n // 4
        for items in (False, True):
            got = _port(s, mt, False, True, items)
            np.testing.assert_array_equal(got[1], ref[1])
    jax.clear_caches()


# ------------------------------------------------------------ packed rows


def _ref_static(jsd):
    """The port's static fields from a reference SceneData; the item knobs
    are the reference's module defaults there."""
    item_defaults = dict(traverse_items=False, items_w=jpt.ITEMS_W,
                         items_max=jpt.ITEMS_MAX, items_cap=jpt.ITEMS_CAP)
    return {k: item_defaults[k] if k in item_defaults else getattr(jsd, k)
            for k in STATIC_FIELDS}


@pytest.fixture(scope="module")
def standin8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return path


def _rays(seed, n=512):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    o[:, 1] += 4.0
    o[:, 2] += 10.0
    tgt = rs.normal(0.0, 1.5, (n, 3)).astype(np.float32)
    tgt[: n // 2, 1] -= 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def test_packed_rows_carried_across(standin8, monkeypatch):
    """RAYITO_PACKED_ROWS=1 makes the reference ship tri_vm_packed and an
    empty tri_vm_rows (its auto rule does so above 96k triangles); the
    port rebuilds the [T, 32] rows and intersects as the reference's
    packed gather does."""
    monkeypatch.setenv("RAYITO_PACKED_ROWS", "1")
    jsd = jdemo.stage6_scene(standin8).compile(**JAX_COMPILE)
    monkeypatch.delenv("RAYITO_PACKED_ROWS")
    assert jsd.tri_vm_rows.shape[0] == 0 and jsd.tri_vm_packed.shape[0] > 0
    arrays = {k: (list(getattr(jsd, k)) if k in DOMAIN_FIELDS
                  else np.asarray(getattr(jsd, k)))
              for k in ARRAY_FIELDS + DOMAIN_FIELDS + ("tri_vm_packed",)}
    ts = scene_data_from_arrays(arrays, _ref_static(jsd), "cpu")
    vert = np.asarray(jsd.tri_vert_rows)
    meta = np.asarray(jsd.tri_meta_rows)
    np.testing.assert_array_equal(ts.tri_vm_rows.numpy(),
                                  np.concatenate([vert, meta], 1))
    n = 512
    o, d = _rays(11, n)
    ref = jtrace.scene_intersect(
        jsd, JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
        JV3(*(jnp.asarray(d[:, k]) for k in range(3))), jnp.zeros(n), 1e-4,
        jnp.full((n,), 1e30, jnp.float32))
    got = ttrace.scene_intersect(
        ts, TV3(*(torch.from_numpy(o[:, k].copy()) for k in range(3))),
        TV3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))), None,
        1e-4, torch.full((n,), 1e30))
    valid = np.asarray(ref.valid)
    assert (valid & (np.asarray(ref.shape_id) >= ts.mesh_id0)).sum() > n // 16
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.shape_id.numpy(),
                                  np.asarray(ref.shape_id))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=1e-5)


# -------------------------------------------------------------- the slice

RENDER = dict(width=32, height=32, pixel_samples=1, light_samples=1,
              max_depth=3, aspect_correction=True)
CAMERA = dict(focal_distance=16.0, lens_radius=0.0)


@pytest.fixture(scope="module")
def big_renders(standin8):
    """The big scene on five n=8 stand-ins: the reference through its item
    route (RAYITO_TRAVERSE_ITEMS=1, read at trace time) at the smallest
    budget that never overflows here (16 ray blocks x the cluster count:
    interpret mode runs all ITEMS_MAX // 4 grid steps of every launch),
    the port through its item route at the same budget and its scan."""
    jsd = jdemo.big_streamed_scene(standin8).compile(**JAX_COMPILE)
    n_cl = jsd.ktab_tri[0].shape[0]
    assert n_cl % 4 == 0 and n_cl <= jpt.ITEMS_CAP
    budget = 16 * n_cl
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYITO_TRAVERSE_ITEMS", "1")
    mp.setattr(jpt, "ITEMS_MAX", budget)
    ref_lists = []
    build_ref = jpt._build_items
    mp.setattr(jpt, "_build_items",
               lambda *a: ref_lists.append(1) or build_ref(*a))
    jax.clear_caches()
    try:
        j_img, _, j_q = jpath.render_path_with_stats(
            jsd, JConfig(**RENDER), JCam.make(40.0, *jdemo.STAGE6_CAMERA,
                                             **CAMERA))
        j_img = np.asarray(j_img, np.float32)
    finally:
        mp.undo()
        jax.clear_caches()
    assert ref_lists  # the reference traced its item route
    cam = TCam.make(40.0, *tdemo.STAGE6_CAMERA, **CAMERA)
    scene = tdemo.big_streamed_scene(standin8)
    out = {}
    overflows = []
    build = tv.build_items

    def spy(*a):
        res = build(*a)
        overflows.append(bool(res[2]))
        return res

    for name, kw in (("items", dict(traverse_items=True, items_max=budget)),
                     ("scan", {})):
        ts = scene.compile("cpu", **kw)
        assert ts.ktab_tri[0].shape[0] == n_cl
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tv, "build_items", spy)
            img, _, q = tpath.render_path_with_stats(ts, TConfig(**RENDER),
                                                     cam)
        out[name] = (img, int(q))
        if name == "items":  # every launch took the item route
            assert overflows and not any(overflows)
            overflows.clear()
    assert not overflows  # the scan render built no item list
    return j_img, int(j_q), out


def test_big_scene_items_render_matches_reference(big_renders):
    j_img, j_q, out = big_renders
    t_img, t_q = out["items"]
    assert t_img.shape == j_img.shape == (32, 32, 3)
    err = float(np.sqrt(np.mean((t_img - j_img) ** 2))
                / max(np.sqrt(np.mean(j_img ** 2)), 1e-20))
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert abs(t_q - j_q) <= 0.001 * j_q, (t_q, j_q)
    assert np.isfinite(t_img).all() and t_img.min() >= 0 and t_img.max() > 0


def test_big_scene_items_render_equals_scan_render(big_renders):
    _, _, out = big_renders
    np.testing.assert_array_equal(out["items"][0].view(np.int32),
                                  out["scan"][0].view(np.int32))
    assert out["items"][1] == out["scan"][1]


def test_big_scene_matches_reference_compile(standin8):
    """Five instances of the stand-in, one merged domain: the tables the
    kernels read are the reference's, bit for bit."""
    jsd = jdemo.big_streamed_scene(standin8).compile(**JAX_COMPILE)
    arrays, static = tdemo.big_streamed_scene(standin8).compile_arrays()
    for k in ("ktab_tri", "ktab_mxu", "ktab_box", "ktab_base"):
        np.testing.assert_array_equal(arrays[k][0],
                                      np.asarray(getattr(jsd, k)[0]))
    for k in ("tri_vm_rows", "mat_rows", "light_color"):
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(jsd, k)))
    assert arrays["tri_vm_rows"].shape[0] == 5 * 768
    assert static["ktab_seg"] == jsd.ktab_seg


@pytest.mark.parametrize("knob,value", [("items_w", 0), ("items_w", 9),
                                        ("items_max", 0), ("items_cap", 0)])
def test_item_fields_are_validated(standin8, knob, value):
    """The reference's ITEMS_W / ITEMS_MAX / ITEMS_CAP checks, on the
    compile-time fields; the defaults are the reference's."""
    scene = tdemo.stage6_scene(standin8)
    with pytest.raises(ValueError, match=knob):
        scene.compile("cpu", **{knob: value})
    sd = scene.compile("cpu", traverse_items=True)
    assert (sd.items_w, sd.items_max, sd.items_cap) == (
        jpt.ITEMS_W, jpt.ITEMS_MAX, jpt.ITEMS_CAP)
