"""A traversal domain's transform chain inside ``ray_pack``
(``rayito_tpu_torch/render/traverse.py`` ``Chain``), on the CPU:

  * ``traverse()`` given the world ray and the domain's chain returns the
    prim and t, bit for bit, of ``traverse()`` given
    ``ops/transform.py`` ``local_ray``'s ray, closest hit and any hit,
    sorted and not; the local ray and the rotation it hands on are
    ``local_ray``'s, and only what the chain asks for comes back;
  * lane times before the first key, after the last and on a key; a
    nested two-link chain against the links applied one by one;
  * in a traced stage-7 pass no ``transforms`` span opens inside a
    ``domain`` span, and ``traverse.chain_lanes`` counts the lanes of the
    moving domain's calls; in stage 6 it reads 0;
  * the scene's per-domain slot table (``SceneData.ktab_chain``) is
    ``chain_slots``' chain at any depth; ``ray_pack`` refuses a chain the
    kernel does not take before anything runs.

The kernel against its plain twin on the card is in
tests/test_torch_cuda.py.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import port_scene, run, standin  # noqa: E402
from rayito_tpu_torch.ops import transform as xf  # noqa: E402
from rayito_tpu_torch.ops.vec3 import V3  # noqa: E402
from rayito_tpu_torch.render import traverse as tv  # noqa: E402
from rayito_tpu_torch.utils import tracing  # noqa: E402

CPU = torch.device("cpu")
N = 3000  # lanes: a ragged launch of two steps


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The benchmark's stage6_bumpy and stage7_motion on the n = 8
    stand-in (768 triangles: a traversal domain)."""
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    standin.write_bumpy_standin(path, n=8)
    return {name: port_scene.build(_config(name), {"bumpy": path}).compile(
        CPU) for name in ("stage6_bumpy", "stage7_motion")}


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.enable(False)
    tracing.reset()


def _moving(scene):
    """The first traversal domain under a chain."""
    return next(di for di, x in enumerate(scene.ktab_xf)
                if xf.chain_slots(scene, x))


def _world_rays(seed=5):
    """N world rays from around the camera at the mesh (radius 1.5 about
    the origin), a few dead (tmax 0), at lane times before the first key,
    after the last, on each of the three keys and between."""
    rs = np.random.default_rng(seed)
    o = np.array([-4.0, 5.0, 15.0]) + rs.uniform(-0.5, 0.5, (N, 3))
    aim = rs.uniform(-1.8, 1.8, (N, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(5.0, 40.0, N)
    tmax[::53] = 0.0
    time = rs.uniform(-0.25, 1.25, N)
    time[:6] = [-1.0, 0.0, 0.5, 1.0, 2.0, 0.25]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    v3 = lambda a: V3(f32(a[:, 0]), f32(a[:, 1]), f32(a[:, 2]))
    return v3(o), v3(d), f32(tmax), f32(time)


def _chain(scene, slots, time, **want):
    return tv.Chain((scene.xf_times, scene.xf_translate, scene.xf_scale,
                     scene.xf_rotate, scene.xf_nkeys),
                    torch.tensor(list(slots), dtype=torch.int32), time,
                    **want)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("mt,any_hit", [("bw", False), ("vpu", True),
                                        ("vpu", False)])
def test_traverse_through_the_chain_equals_traverse_of_the_local_ray(
        scenes, mt, any_hit, sort_rays):
    scene = scenes["stage7_motion"]
    di = _moving(scene)
    o, d, tmax, time = _world_rays()
    tri = scene.ktab_tri[di] if mt == "vpu" else scene.ktab_mxu[di]
    kw = dict(mt_mode=mt, any_hit=any_hit, sort_rays=sort_rays,
              slices=scene.ktab_slice[di])
    slots = scene.ktab_chain[di]
    assert slots.tolist() == xf.chain_slots(scene, scene.ktab_xf[di])
    chain = _chain(scene, slots.tolist(), time, want_ray=True,
                   want_rot=True)
    assert torch.equal(chain.slots, slots)
    t, p, (ray, rot) = tv.traverse(o, d, tmax, scene.ktab_box[di], tri,
                                   1e-4, chain=chain, **kw)
    o_l, d_l, rot_l = xf.local_ray(scene, scene.ktab_xf[di], o, d, time)
    t_l, p_l = tv.traverse(o_l, d_l, tmax, scene.ktab_box[di], tri, 1e-4,
                           **kw)
    assert int((p_l >= 0).sum()) > 100
    assert _same(t, t_l) and torch.equal(p, p_l)
    assert _same(ray, torch.stack((o_l.x, o_l.y, o_l.z, d_l.x, d_l.y,
                                   d_l.z)))
    assert _same(rot, torch.stack((rot_l.w, rot_l.v.x, rot_l.v.y,
                                   rot_l.v.z)))


@pytest.mark.parametrize("want_ray,want_rot",
                         [(False, False), (True, False), (False, True)])
def test_only_what_the_chain_asks_for_comes_back(scenes, want_ray, want_rot):
    scene = scenes["stage7_motion"]
    di = _moving(scene)
    o, d, tmax, time = _world_rays(seed=8)
    chain = _chain(scene, xf.chain_slots(scene, scene.ktab_xf[di]), time,
                   want_ray=want_ray, want_rot=want_rot)
    soa8, operand, (ray, rot) = tv.ray_pack(o, d, tmax, scene.ktab_box[di],
                                            1e-4, chain=chain)
    assert (ray is not None) == want_ray and (rot is not None) == want_rot
    full = tv.ray_pack(o, d, tmax, scene.ktab_box[di], 1e-4,
                       chain=dataclasses.replace(chain, want_ray=True,
                                                 want_rot=True))
    assert _same(soa8, full[0]) and _same(operand, full[1])
    for got, ref in zip((ray, rot), full[2]):
        assert got is None or _same(got, ref)
    # the rows are the local ray's
    assert _same(soa8[:N, :6].t(), full[2][0])


def test_a_nested_chain_applies_its_links_outermost_first(scenes):
    """Two links of stage 7's tables, one keyed, one a constant: the twin
    equals the links taken one by one through ``ray_to_local_chain``."""
    scene = scenes["stage7_motion"]
    o, d, tmax, time = _world_rays(seed=9)
    keyed = [s for s in range(1, scene.xf_nkeys.shape[0])
             if int(scene.xf_nkeys[s]) > 1]
    one = [s for s in range(1, scene.xf_nkeys.shape[0])
           if int(scene.xf_nkeys[s]) == 1]
    slots = (keyed[0], one[0])
    chain = _chain(scene, slots, time, want_ray=True, want_rot=True)
    _, _, (ray, rot) = tv.ray_pack(o, d, tmax, scene.ktab_box[0], 1e-4,
                                   chain=chain)
    tables = (scene.xf_times, scene.xf_translate, scene.xf_scale,
              scene.xf_rotate, scene.xf_nkeys)
    links = [xf.eval_transform(*tables, s, time) for s in slots[::-1]]
    o_l, d_l, rot_l = xf.ray_to_local_chain(links, o, d)
    assert _same(ray, torch.stack((o_l.x, o_l.y, o_l.z, d_l.x, d_l.y,
                                   d_l.z)))
    assert _same(rot, torch.stack((rot_l.w, rot_l.v.x, rot_l.v.y,
                                   rot_l.v.z)))
    # the outer link moved the ray: not the inner link's ray alone
    inner = xf.ray_to_local_chain(links[:1], o, d)[0]
    assert not torch.equal(ray[0], inner.x)


def _pass(scene, name, traced=True):
    """One eager path pass of a 24x16 frame, one sample, depth 2, traced:
    its snapshot."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=24, height=16, pixel_samples=1, light_samples=1,
                       max_depth=2, max_rays_per_pass=24 * 16, seed=7)
    cam = run.camera_of(_config(name)["camera"])
    si = torch.zeros(1, dtype=torch.int32)
    row0 = torch.zeros((), dtype=torch.int32)
    with tracing.on(traced):
        tracing.reset()
        pt._path_pass_body(scene, cfg, cam, si, row0, 16)
        snap = tracing.snapshot()
        tracing.reset()
    return snap


@pytest.mark.parametrize("name", ["stage7_motion", "stage6_bumpy"])
def test_no_transforms_span_in_a_domain_and_the_chain_lanes(scenes, name):
    scene = scenes[name]
    snap = _pass(scene, name)
    by_id = {s.id: s for s in snap.device}

    def inside_domain(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            if s.name == "domain":
                return True
        return False

    names = [s.name for s in snap.device]
    assert names.count("domain") > 0
    assert not any(s.name == "transforms" and inside_domain(s)
                   for s in snap.device)
    c = snap.counters
    chained = sum(bool(xf.chain_slots(scene, x)) for x in scene.ktab_xf)
    # depth 2: a closest-hit and two any-hit queries a bounce, each
    # domain once a query; a scene without a chain never adds the counter,
    # which reads 0 there
    assert c["traverse.lanes"] == 2 * 3 * len(scene.ktab_xf) * 384
    assert c.get("traverse.chain_lanes", 0) == 2 * 3 * chained * 384
    assert (chained > 0) == (name == "stage7_motion")
    assert ("traverse.chain_lanes" in c) == (chained > 0)
    assert _pass(scene, name, traced=False).counters == {}


def test_a_domain_chain_of_any_depth_gets_its_slot_table(scenes):
    """The chain of slot s is s, s - 1, ..., 0: a domain under slot 599 is
    600 links deep. The scene's slot table holds the whole chain, and
    ``ray_pack`` through it is ``local_ray``'s ray, bit for bit."""
    scene = scenes["stage7_motion"]
    depth = 600
    rows = torch.arange(depth) % scene.xf_times.shape[0]  # stage 7's keys
    deep = dataclasses.replace(
        scene, ktab_xf=(depth - 1,),
        xf_parent_host=tuple(range(-1, depth - 1)),
        xf_parent=torch.arange(-1, depth - 1, dtype=torch.int32),
        **{k: getattr(scene, k)[rows] for k in (
            "xf_times", "xf_translate", "xf_scale", "xf_rotate",
            "xf_nkeys")})
    assert deep.ktab_chain[0].dtype == torch.int32
    assert deep.ktab_chain[0].tolist() == list(range(depth))
    o, d, tmax, time = _world_rays(seed=6)
    cut = lambda v: V3(v.x[:256], v.y[:256], v.z[:256])
    o, d, tmax, time = cut(o), cut(d), tmax[:256], time[:256]
    chain = tv.Chain((deep.xf_times, deep.xf_translate, deep.xf_scale,
                      deep.xf_rotate, deep.xf_nkeys), deep.ktab_chain[0],
                     time, want_ray=True, want_rot=True)
    _, _, (ray, rot) = tv.ray_pack(o, d, tmax, deep.ktab_box[0], 1e-4,
                                   chain=chain)
    o_l, d_l, rot_l = xf.local_ray(deep, depth - 1, o, d, time)
    assert _same(ray, torch.stack((o_l.x, o_l.y, o_l.z, d_l.x, d_l.y,
                                   d_l.z)))
    assert _same(rot, torch.stack((rot_l.w, rot_l.v.x, rot_l.v.y,
                                   rot_l.v.z)))


def _bad_chains(scene, time):
    ok = _chain(scene, (1,), time)
    tables = ok.tables
    return {
        "no_slots": dataclasses.replace(ok, slots=ok.slots[:0]),
        "i64_slots": dataclasses.replace(ok, slots=ok.slots.long()),
        "slot_matrix": dataclasses.replace(ok, slots=ok.slots[None]),
        "strided_slots": dataclasses.replace(
            ok, slots=torch.ones(4, dtype=torch.int32)[::2]),
        "short_time": dataclasses.replace(ok, time=time[:-1]),
        "f64_time": dataclasses.replace(ok, time=time.double()),
        "i64_nkeys": dataclasses.replace(
            ok, tables=tables[:4] + (tables[4].long(),)),
        "rotation_of_3": dataclasses.replace(
            ok, tables=tables[:3] + (tables[3][..., :3],) + tables[4:]),
    }


@pytest.mark.parametrize("case", ["no_slots", "i64_slots", "slot_matrix",
                                  "strided_slots", "short_time", "f64_time",
                                  "i64_nkeys", "rotation_of_3"])
def test_ray_pack_refuses_a_chain_the_kernel_does_not_take(scenes, case):
    scene = scenes["stage7_motion"]
    o, d, tmax, time = _world_rays(seed=4)
    chain = _bad_chains(scene, time)[case]
    tv.ray_pack.launches = 0
    with pytest.raises(ValueError):
        tv.ray_pack(o, d, tmax, scene.ktab_box[0], 1e-4, chain=chain)
    assert tv.ray_pack.launches == 0
