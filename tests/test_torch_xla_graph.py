"""The ``traversal='xla'`` route on static shapes, on the CPU: nothing in a
query reads the device back, so its passes are captured as CUDA graphs on
the card (``utils/graphs.run``) like the kernel route's.

Scenes, rays and seeds are ``tests/test_torch_xla.py``'s (the 420-layer
stack that truncates at both levels, stage 6 on the n=8 stand-in):

  * (a) ``cluster_pipeline_plain``, per compacted slot, equals the
    pipeline's phases 2-3 as they ran per chunk of compacted rays before
    the route was put on static shapes (``_chunk_before``, kept here
    verbatim): t and prim bits, overflow per ray; slots at or past
    ``n_active`` are INF / -1 / 0; the plain version's batching does not
    move a bit;
  * (b) ``mesh_intersect_clusters`` against the reference's, as
    ``test_mesh_intersect_clusters_matches_reference`` holds it, with
    ``n_active`` exactly on the edge of the reference's last block of
    R = 256 slots (768 of 1,000 lanes) and one above it, where the
    reference's 24 pad slots count lane 0 again: overflow equal;
  * (c) one 'xla' ``scene_intersect`` and one ``scene_occluded`` on stage
    6 under a dispatch mode that raises on ``aten._local_scalar_dense``
    (``.item()``, ``int()``, ``bool()`` of a tensor) and ``aten.nonzero``;
    only the plain twin's own read of ``n_active`` is let through;
  * (d) 32x32 'xla' ``render_path_with_stats`` frames of stage 6 and of
    the layered stack (which overflows), equal bit for bit, in overflow
    and in queries, to the frames the route gave before it was put on
    static shapes (pinned: the image's SHA-256, overflow, queries).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rayito_tpu_torch as tt
from rayito_tpu.render import mesh_intersect as jmi
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import mesh_intersect as tmi
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from test_torch_xla import (  # noqa: F401  (fixtures)
    _both_v3, _close, _layers, _mi_rays, _one_torch_thread, _render_kw,
    _scene_rays, compiled, standin8)

INF = float("inf")


def _chunk_before(scene, mi, t_sc, o, d, tmin, tmax, k1, k2):
    """Phases 2-3 for compacted rays o, d [R] with their phase-1 rows
    t_sc [R, S], as the route computed them per chunk before it was put on
    static shapes: (t [R], global prim [R], overflow per ray [R])."""
    sc0 = scene.mesh_sc_ranges[mi][0]
    cl0 = scene.mesh_cl_ranges[mi][0]
    tri0 = scene.mesh_tri_ranges[mi][0]
    n_r = t_sc.shape[0]
    inv = TV3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    T = 48

    t1, sc_idx = tv.nearest_k(t_sc, k1)
    ovf = torch.clamp_min(torch.isfinite(t_sc).sum(1) - k1, 0)
    rows = scene.sc_rows[sc0 + sc_idx]  # [R, k1, 128]
    col = lambda c: rows[:, :, c * 16:(c + 1) * 16]
    t_cl = tv.box_slab(o, inv, tmin, tmax, TV3(col(0), col(1), col(2)),
                       TV3(col(3), col(4), col(5)))
    t_cl = torch.where((t1 < INF)[:, :, None], t_cl, INF).reshape(n_r, k1 * 16)
    ovf = ovf + torch.clamp_min((t_cl < INF).sum(1) - k2, 0)
    t2, cand = tv.nearest_k(t_cl, k2)
    sc_sel = sc_idx.gather(1, cand >> 4)
    cl_sel = sc_sel * 16 + (cand & 15)

    trows = scene.tri_rows[cl0 + cl_sel]  # [R, k2, 512]
    comp = lambda b: trows[:, :, b * T:(b + 1) * T]
    v0x, v0y, v0z = comp(0), comp(1), comp(2)
    v1x, v1y, v1z = comp(3), comp(4), comp(5)
    v2x, v2y, v2z = comp(6), comp(7), comp(8)
    ex = (slice(None), None, None)
    dx, dy, dz = d.x[ex], d.y[ex], d.z[ex]
    ox, oy, oz = o.x[ex], o.y[ex], o.z[ex]
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    det = -(dx * gnx + dy * gny + dz * gnz)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    t0x, t0y, t0z = v0x - ox, v0y - oy, v0z - oz
    rcx = dy * t0z - dz * t0y
    rcy = dz * t0x - dx * t0z
    rcz = dx * t0y - dy * t0x
    t1x, t1y, t1z = v1x - ox, v1y - oy, v1z - oz
    gamma = -(t1x * rcx + t1y * rcy + t1z * rcz) * inv_det
    t2x, t2y, t2z = v2x - ox, v2y - oy, v2z - oz
    beta = (t2x * rcx + t2y * rcy + t2z * rcz) * inv_det
    t = -(t0x * gnx + t0y * gny + t0z * gnz) * inv_det
    hit = ((det != 0.0) & (gamma >= 0.0) & (gamma <= 1.0) & (beta >= 0.0)
           & (beta + gamma <= 1.0) & (t >= tmin) & (t < tmax[ex])
           & (t2 < INF)[:, :, None])
    t_tri = torch.where(hit, t, INF).reshape(n_r, k2 * T)
    arg = torch.argmin(t_tri, dim=1, keepdim=True)
    cl_win = cl_sel.gather(1, arg // T)[:, 0]
    prim = (tri0 + cl_win * T + arg[:, 0] % T).to(torch.int32)
    return t_tri.gather(1, arg)[:, 0], prim, ovf


def _torch_rays(case):
    mi, o, d, tmax = _mi_rays(case)
    return mi, _both_v3(o)[1], _both_v3(d)[1], torch.from_numpy(tmax)


@pytest.mark.parametrize("case", ["layers", "stage6"])
def test_plain_pipeline_equals_the_chunked_route(compiled, case,
                                                 monkeypatch):
    sd = compiled(case)[3]
    mi, o, d, tmax = _torch_rays(case)
    args, slot = tmi.pipeline_inputs(sd, mi, o, d, 1e-4, tmax)
    n_act = int(args["n_active"])
    ros = args["ray_of_slot"]
    # the slot order: the lanes with a candidate ascending, then the rest
    has = torch.isfinite(args["t_sc"]).any(1)
    assert torch.equal(ros[:n_act], torch.nonzero(has)[:, 0].int())
    assert torch.equal(ros[n_act:], torch.nonzero(~has)[:, 0].int())
    assert torch.equal(ros[slot.long()], torch.arange(1000, dtype=torch.int32))
    assert 0 < n_act < 1000
    got = tv.cluster_pipeline(**args)
    lanes = ros[:n_act].long()
    want = _chunk_before(sd, mi, args["t_sc"][lanes], o[lanes], d[lanes],
                         1e-4, tmax[lanes], args["k1"], args["k2"])
    assert torch.equal(got[0][:n_act].view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1][:n_act], want[1])
    assert torch.equal(got[2][:n_act].long(), want[2])
    assert (got[0][n_act:] == INF).all() and (got[1][n_act:] == -1).all()
    assert not got[2][n_act:].any()
    assert got[2].dtype == got[1].dtype == torch.int32
    if case == "layers":
        assert int(got[2].sum()) > 1000 and (want[1] >= 0).any()
    # the plain version's batching moves no bit
    monkeypatch.setattr(tv, "PIPELINE_CHUNK", 97)
    for a, b in zip(tv.cluster_pipeline(**args), got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _edge_rays(sd, n_active):
    """The layered case's 1,000 rays with tmax 0 from the lane at which
    ``n_active`` lanes with a candidate lie below it (those lanes keep
    none)."""
    mi, o, d, tmax = _mi_rays("layers")
    _, to, td, _ = _torch_rays("layers")
    args, _ = tmi.pipeline_inputs(sd, mi, to, td, 1e-4,
                                  torch.from_numpy(tmax))
    ros = args["ray_of_slot"]
    assert n_active < int(args["n_active"])
    tmax[int(ros[n_active]):] = 0.0
    return mi, o, d, tmax


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_active", [768, 769])
def test_pad_slots_at_the_last_block_edge(compiled, n_active, any_hit):
    """1,000 lanes: the reference runs blocks of R = 256 compacted slots
    while ci * R < n_active; at 768 its fourth block (24 pad slots of lane
    0) never runs, at 769 it does."""
    jsd, _, _, tsd = compiled("layers")
    mi, o, d, tmax = _edge_rays(tsd, n_active)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    args, _ = tmi.pipeline_inputs(tsd, mi, to, td, 1e-4,
                                  torch.from_numpy(tmax))
    assert int(args["n_active"]) == n_active
    ref = jmi.mesh_intersect_clusters(jsd, mi, jo, jd, 1e-4,
                                      jnp.asarray(tmax), any_hit=any_hit)
    got = tmi.mesh_intersect_clusters(tsd, mi, to, td, 1e-4,
                                      torch.from_numpy(tmax), any_hit=any_hit)
    assert int(got[4]) == int(ref[4])
    rp, gp = np.asarray(ref[1]), got[1].numpy()
    rt_, gt = np.asarray(ref[0]), got[0].numpy()
    hit = (rp >= 0) & (gp >= 0)
    tie = (rp != gp) & hit
    tie[tie] = _close(gt[tie], rt_[tie])
    assert ((rp != gp) & ~tie).sum() == 0 and tie.sum() <= 1
    assert _close(gt[hit], rt_[hit]).all() and hit.sum() > 500
    if not any_hit:
        same = hit & ~tie
        for k in (2, 3):
            assert _close(got[k].numpy()[same], np.asarray(ref[k])[same]).all()
    # the pad term: lane 0's count 24 times, only when the last block runs
    per_lane = int(tv.cluster_pipeline(**args)[2].sum())
    lane0 = int(tv.cluster_pipeline(**args)[2][0])
    assert lane0 > 0 and int(args["ray_of_slot"][0]) == 0
    assert int(got[4]) - per_lane == (24 * lane0 if n_active > 768 else 0)


class _NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor back to the host, unless
    ``exempt``; counts the exempted calls."""

    banned = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero)

    def __init__(self):
        super().__init__()
        self.exempt = False
        self.exempted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.banned:
            if not self.exempt:
                raise AssertionError(f"host read in the route: {func}")
            self.exempted += 1
        return func(*args, **(kwargs or {}))


def test_xla_queries_read_nothing_back(compiled, monkeypatch):
    jsd, _, _, tsd = compiled("stage6")
    o, d, time = _scene_rays("stage6", 11)
    (_, to), (_, td) = _both_v3(o), _both_v3(d)
    tmax = torch.from_numpy(
        np.random.default_rng(12).uniform(1.0, 14.0, 512).astype(np.float32))
    mode = _NoHostRead()
    plain = tv.cluster_pipeline_plain

    def exempted(*a, **kw):  # the plain twin's own read of n_active
        mode.exempt = True
        try:
            return plain(*a, **kw)
        finally:
            mode.exempt = False

    monkeypatch.setattr(tv, "cluster_pipeline_plain", exempted)
    with mode:
        with pytest.raises(AssertionError, match="host read"):
            int(torch.ones(()))
        hit = ttrace.scene_intersect(tsd, to, td, None, 1e-4, 1e30)
        occ, ovf = ttrace.scene_occluded(tsd, to, td, None, 1e-4, tmax)
    assert mode.exempted == 2 * tsd.n_meshes  # one read per mesh query
    ref = ttrace.scene_intersect(tsd, to, td, None, 1e-4, 1e30)
    for k in ("t", "shape_id", "mat"):
        assert torch.equal(getattr(hit, k), getattr(ref, k)), k
    assert int(hit.valid.sum()) > 128 and 0 < int(occ.sum()) < 512
    assert int(hit.overflow) == int(ovf) == 0


# 32x32 'xla' frames of the route before it was put on static shapes:
# SHA-256 of the float32 image, overflow, queries. The digests are those
# frames' with every square root of the port correctly rounded (ops/vec3
# sqrt_ieee). With PyTorch's CPU root everywhere but the camera and the
# quaternion normalize, as before, the same code gives the frames pinned
# before: 7ef683ea6834617fbb8954778466e5b15769b972876c331adf3518917035c6e5
# (stage 6) and 80e5712288eb2e749a5e3ec1b602f1b65d52689a4167a988eb9e1e718a1b16aa
# (layers); with torch.sqrt in the camera too, stage 6 gives
# 9587eb082b882c3d7695245283e1ae5a9e6bc4b97a21b3ed39478c6c0d134242
PINNED = {
    "stage6": ("816a0fcd5f5a1eb480bd445af2661dfdfc881c6e82575159bfe846d84761b0f7",
               0, 3270),
    "layers": ("750fff3d0e9f872e2477b570e914f03342fb0c25f324d672c4e696b399c8da6c",
               3046, 2692),
}


@pytest.mark.parametrize("scene", ["stage6", "layers"])
def test_xla_frame_is_the_one_before(compiled, scene):
    kw = _render_kw("stage6")[0]
    if scene == "stage6":
        sd = compiled("stage6")[3]
        cam = TCam.make(30.0, *tdemo.STAGE6_CAMERA, focal_distance=16.0,
                        lens_radius=0.0, shutter_open=0.0, shutter_close=0.0)
    else:
        sd = _layers(tt, light=True).compile("cpu", traversal="xla")
        cam = TCam.make(25.0, (0.0, 0.3, -6.0), (0.0, 0.0, 10.0), (0, 1, 0),
                        focal_distance=16.0, lens_radius=0.0)
    img, ovf, q = tpath.render_path_with_stats(sd, TConfig(**kw), cam)
    digest = hashlib.sha256(
        np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()
    assert (digest, ovf, q) == PINNED[scene]
