"""Port parity: the kernel route's tiny transformed meshes (``ktab_small``)
on the CPU, where ``fold_small`` (``render/mesh_intersect.py``) runs its
plain twin ``fold_small_query_plain``; the kernel (``csrc/fold_small.cu``)
is held against that twin on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Four scenes, built by each package from one definition (``models/demo.py``
of the port, with the reference package's classes for the reference) and
compiled by the reference with the main path's settings
(traversal='pallas', tiny_fold=False):

  * ``stage7b``: ``stage7_scene2``'s ten tumbling cubes (two keys each);
  * ``one_key``: a cube under a rotated, scaled, translated transform of
    one key, in a scene whose every slot has one key (the K == 1 branch of
    ``eval_transform``, which does not normalise);
  * ``nested``: a cube with two keys of its own inside a group that turns
    over the shutter (a chain of depth 2);
  * ``outside``: the nested scene at lane times in [-0.5, 1.5], outside the
    keys' [0, 1] on either side (pegged to the end keys).

Seeded rays (numpy) at seeded lane times, some cut short by tmax:

  * the tiny-mesh fold against the reference's own loop over its tiny
    meshes (``rayito_tpu/render/trace.py:628-650``: ``_mesh_local_ray`` and
    ``mesh_intersect_clusters`` per mesh, each capped at the best so far),
    from a running best with hits of its own: prim exact, t, beta, gamma
    and the winner's rotation to rtol = atol = 1e-6 (XLA may contract a
    multiply-add into one FMA; PyTorch rounds twice); the any-hit form
    against the reference's occlusion loop, exact;
  * ``scene_intersect`` and ``scene_occluded`` against the reference's:
    hit, shape and occlusion exact, t to rtol = atol = 1e-6 at hits;
  * the rows past each tiny mesh's triangle count in ``tri_vert_rows`` are
    zero and never hit: the fold over the padded rows equals the fold over
    the real rows alone, which is what the kernel tests;
  * the kernel's launch list (``_fold_specs``): meshes in ``ktab_small``
    order, chains outermost first in the launch's slot table, cut at the
    kernel's mesh, row and link limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import mesh_intersect as jmi
from rayito_tpu.render import trace as jtrace
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.ops.quaternion import Quat
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import mesh_intersect as tmi
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.render import traverse as tv

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
SCENES = ("stage7b", "one_key", "nested", "outside")
N_RAYS = 384
TMIN = 1e-4
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' many small ops spin threads on a loaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name):
    if name == "stage7b":
        return jdemo.stage7_scene2(), tdemo.stage7_scene2()
    if name == "one_key":
        return tdemo.one_key_cube_scene(rt), tdemo.one_key_cube_scene()
    return tdemo.nested_cube_scene(rt), tdemo.nested_cube_scene()


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for name in ("stage7b", "one_key", "nested"):
        js, ts = _build(name)
        out[name] = (js.compile(**JAX_COMPILE), ts.compile("cpu"))
    out["outside"] = out["nested"]
    return out


def _rays(name, n=N_RAYS):
    """Seeded rays at the scene's tiny meshes: (o, d, tmax, time) numpy."""
    rs = np.random.default_rng({"stage7b": 11, "one_key": 12, "nested": 13,
                                "outside": 14}[name])
    if name == "stage7b":
        # the cubes fall from (10, 10, 2) towards -x over the shutter
        o = np.tile(np.float32([-4.0, 10.0, 30.0]), (n, 1))
        target = np.stack([rs.uniform(-10.0, 11.0, n),
                           rs.uniform(-2.0, 11.0, n),
                           rs.uniform(1.0, 4.0, n)], 1)
    else:
        o = np.tile(np.float32([0.3, 0.8, 6.0]), (n, 1))
        target = rs.uniform(-1.2, 1.6, (n, 3))
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::9] = rs.uniform(1.0, 6.0, tmax[::9].shape)  # some end early
    lo, hi = (-0.5, 1.5) if name == "outside" else (0.0, 1.0)
    time = rs.uniform(lo, hi, n).astype(np.float32)
    return o.astype(np.float32), d, tmax, time


def _tv3(a):
    return TV3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _running_best(jsd, o, d, tmax):
    """A best the fold starts from, with hits of its own: the plane's, or
    INF where a lane misses it (numpy: t, prim, beta, gamma, rot)."""
    n = o.shape[0]
    t = np.full(n, np.inf, np.float32)
    ny = d[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = ((-2.0 - o[:, 1]) / ny).astype(np.float32)
    hit = (ny < 0) & (tp > TMIN) & (tp < tmax)
    t[hit] = tp[hit]
    prim = np.full(n, -1, np.int32)
    prim[hit] = 7  # any id: the fold only carries it
    beta = np.where(hit, 0.25, 0.0).astype(np.float32)
    gamma = np.where(hit, 0.5, 0.0).astype(np.float32)
    rot = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (n, 1))
    return t, prim, beta, gamma, rot


def _ref_fold(jsd, o, d, time, tmax, best):
    """The reference's tiny-mesh loop (trace.py:628-650), from ``best``."""
    t_b, p_b, b_b, g_b, rot = (jnp.asarray(a) for a in best)
    rot = [rot[:, k] for k in range(4)]
    o, d, tm = _jv3(o), _jv3(d), jnp.asarray(time)
    for mi in jsd.ktab_small:
        o_l, d_l, r = jtrace._mesh_local_ray(jsd, mi, o, d, tm)
        t_m, p_m, b_m, g_m, _ = jmi.mesh_intersect_clusters(
            jsd, mi, o_l, d_l, TMIN, jnp.minimum(t_b, jnp.asarray(tmax)))
        c = p_m >= 0
        t_b, p_b = jnp.where(c, t_m, t_b), jnp.where(c, p_m, p_b)
        b_b, g_b = jnp.where(c, b_m, b_b), jnp.where(c, g_m, g_b)
        rot = [jnp.where(c, x, y) for x, y in
               zip((r.w, r.v.x, r.v.y, r.v.z), rot)]
    return [np.asarray(a) for a in (t_b, p_b, b_b, g_b)], np.stack(
        [np.asarray(x) for x in rot], 1)


def _ref_occluded(jsd, o, d, time, tmax, occ):
    o, d, tm = _jv3(o), _jv3(d), jnp.asarray(time)
    occ = jnp.asarray(occ)
    for mi in jsd.ktab_small:
        o_l, d_l, _ = jtrace._mesh_local_ray(jsd, mi, o, d, tm)
        _, p_m, _, _, _ = jmi.mesh_intersect_clusters(
            jsd, mi, o_l, d_l, TMIN, jnp.where(occ, 0.0, jnp.asarray(tmax)),
            any_hit=True)
        occ = occ | (p_m >= 0)
    return np.asarray(occ)


def test_scenes_take_the_kernel_paths(compiled):
    """Each scene's tiny meshes, key counts and chain depths are the ones
    the cases name."""
    assert compiled["stage7b"][1].ktab_small == tuple(range(10))
    one = compiled["one_key"][1]
    assert one.xf_times.shape[1] == 1 and one.ktab_small == (0,)
    nest = compiled["nested"][1]
    assert nest.ktab_small == (0, 1) and nest.xf_depth == 2
    assert [len(tmi._chain(nest, mi)) for mi in nest.ktab_small] == [2, 1]


@pytest.mark.parametrize("name", SCENES)
def test_fold_matches_reference_loop(compiled, name):
    """The tiny-mesh fold from a running best against the reference's loop
    over its tiny meshes: prim exact, t, beta, gamma and the rotation at
    the fold's own hits to 1e-6; the any-hit form exact."""
    jsd, tsd = compiled[name]
    o, d, tmax, time = _rays(name)
    best = _running_best(jsd, o, d, tmax)
    (t_r, p_r, b_r, g_r), rot_r = _ref_fold(jsd, o, d, time, tmax, best)
    t_b, p_b, b_b, g_b, rot = (torch.from_numpy(a.copy()) for a in best)
    got = tmi.fold_small(
        tsd, _tv3(o), _tv3(d), torch.from_numpy(time), TMIN,
        torch.from_numpy(tmax),
        best=(t_b, p_b, b_b, g_b,
              Quat(rot[:, 0], TV3(rot[:, 1], rot[:, 2], rot[:, 3]))))
    prim = got[1].numpy()
    np.testing.assert_array_equal(prim, p_r)
    mesh_hit = prim != best[1]
    assert mesh_hit.sum() >= 10, mesh_hit.sum()  # the meshes are reached
    hit = prim >= 0
    np.testing.assert_allclose(got[0].numpy()[hit], t_r[hit], **TOL)
    for k, ref in ((2, b_r), (3, g_r)):
        np.testing.assert_allclose(got[k].numpy()[hit], ref[hit], **TOL)
    q = got[4]
    rot_got = np.stack([t.numpy() for t in (q.w, q.v.x, q.v.y, q.v.z)], 1)
    np.testing.assert_allclose(rot_got[mesh_hit], rot_r[mesh_hit], **TOL)
    occ0 = np.zeros(o.shape[0], bool)
    occ0[::5] = True
    occ = tmi.fold_small(tsd, _tv3(o), _tv3(d), torch.from_numpy(time), TMIN,
                         torch.from_numpy(tmax),
                         occluded=torch.from_numpy(occ0))
    occ_r = _ref_occluded(jsd, o, d, time, tmax, occ0)
    np.testing.assert_array_equal(occ.numpy(), occ_r)
    assert (occ_r & ~occ0).sum() >= 10


@pytest.mark.parametrize("name", SCENES)
def test_scene_queries_match_reference(compiled, name):
    """scene_intersect and scene_occluded, whose meshes are all tiny:
    valid, shape and occlusion exact, t at hits to 1e-6."""
    jsd, tsd = compiled[name]
    o, d, tmax, time = _rays(name)
    ref = jtrace.scene_intersect(jsd, _jv3(o), _jv3(d), jnp.asarray(time),
                                 TMIN, jnp.asarray(tmax))
    got = ttrace.scene_intersect(tsd, _tv3(o), _tv3(d),
                                 torch.from_numpy(time), TMIN,
                                 torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.shape_id.numpy(),
                                  np.asarray(ref.shape_id))
    v = got.valid.numpy()
    assert (got.shape_id.numpy() >= tsd.mesh_id0).sum() >= 10
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v], **TOL)
    occ_r = jtrace.scene_occluded(jsd, _jv3(o), _jv3(d), jnp.asarray(time),
                                  TMIN, jnp.asarray(tmax))
    occ, _ = ttrace.scene_occluded(tsd, _tv3(o), _tv3(d),
                                   torch.from_numpy(time), TMIN,
                                   torch.from_numpy(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r[0]))


def test_pad_rows_never_hit(compiled):
    """Every tiny mesh's rows past its count are zero, and the fold over
    its padded rows equals the fold over its real rows alone on rays that
    pass through the origin, where the zero triangles sit."""
    rs = np.random.default_rng(21)
    n = 512
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = -o + rs.normal(0.0, 0.05, (n, 3))
    d[::4] = -o[::4]  # straight through the origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::16, 0] = 0.0  # a zero component
    tmax = torch.full((n,), 1e30)
    for name in ("stage7b", "one_key", "nested"):
        tsd = compiled[name][1]
        for mi in tsd.ktab_small:
            tri0, count = tsd.mesh_tri_ranges[mi]
            padded = tsd.tri_vert_rows[tri0:tri0 + 48]
            assert count < 48 and not padded[count:].any()
            full = tv.fold_small_plain(padded, tri0, _tv3(o), _tv3(d), TMIN,
                                       tmax)
            real = tv.fold_small_plain(padded[:count], tri0, _tv3(o), _tv3(d),
                                       TMIN, tmax)
            hit = full[1] >= 0
            assert torch.equal(full[1], real[1]) and int(hit.sum()) > 0
            assert torch.equal(full[0].view(torch.int32),
                               real[0].view(torch.int32))
            for k in (2, 3):
                assert torch.equal(full[k][hit], real[k][hit])


def test_launch_list(compiled, monkeypatch):
    """The kernel's launch list: ktab_small order, each mesh's real rows
    and its chain outermost first in the launch's slot table; cut where the
    mesh, row or link limit would overflow, a chain longer than the table
    refused."""
    nest = compiled["nested"][1]
    (spec,) = tmi._fold_specs(nest)
    assert (spec.n_mesh, spec.rows, spec.k, spec.n_link) == (2, 24, 2, 3)
    m0, m1 = spec.mesh[0], spec.mesh[1]
    cube_slot, still_slot = nest.mesh_xf_host
    group_slot = nest.xf_parent_host[cube_slot]
    assert (m0.row0, m0.count, m0.link0, m0.depth) == (
        nest.mesh_tri_ranges[0][0], 12, 0, 2)
    assert list(spec.slots[:2]) == [group_slot, cube_slot]
    assert (m1.count, m1.link0, m1.depth) == (12, 2, 1)
    assert spec.slots[2] == still_slot
    s7b = compiled["stage7b"][1]
    monkeypatch.setattr(tmi, "FOLD_MAX_MESHES", 4)
    assert [s.n_mesh for s in tmi._fold_specs(s7b)] == [4, 4, 2]
    monkeypatch.setattr(tmi, "FOLD_MAX_MESHES", 64)
    monkeypatch.setattr(tmi, "FOLD_MAX_ROWS", 36)
    assert [s.rows for s in tmi._fold_specs(s7b)] == [36, 36, 36, 12]
    monkeypatch.setattr(tmi, "FOLD_MAX_ROWS", 1024)
    monkeypatch.setattr(tmi, "FOLD_MAX_LINKS", 3)
    assert [s.n_link for s in tmi._fold_specs(s7b)] == [3, 3, 3, 1]
    monkeypatch.setattr(tmi, "FOLD_MAX_LINKS", 1)
    with pytest.raises(ValueError, match="chain of 2"):
        tmi._fold_specs(nest)
