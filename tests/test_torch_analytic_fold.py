"""The analytic fold's launch list, its wrapper's refusals and the tie and
NaN rule of its plain twin, on the CPU.

``render/trace.py`` folds the analytic shapes of a query (every plane,
sphere and rect) through ``analytic_fold``: on the card one launch of
``csrc/analytic_fold.cu`` (more past its limits), on the CPU the plain
twin ``analytic_fold_plain``. The kernel is held to the twin bit for bit
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 28);
what these tests pin is what the kernel is given and what it must do:

  * the launch list (``_af_specs``): rows in the twin's order (planes,
    spheres, rects, each ascending), each keyed row's chain outermost
    first, no chain for a static row or any row of a static scene, one
    chain per distinct slot, cut at the kernel's row and chain limits;
  * the wrapper's refusals: mixed devices, lanes that are not [N] f32, a
    time where the scene does not move or none where it does;
  * the twin's contract: the nearest hit over every row in that order
    under a strict <, so ties go to the earlier kind and the lower row (a
    row-by-row walk gives the same bits); NaN and infinite rays miss and
    keep the fold's start; any hit is "some row hits".
"""

import ctypes

import numpy as np
import pytest
import torch

import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo
from rayito_tpu_torch.ops import transform as xf
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import trace as tr
from rayito_tpu_torch.utils import cuda_lib

N = 2048


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy2.obj")
    demo.write_bumpy_standin(path, n=2)
    return path


def _nested():
    """A bullseye plane at the root; a sphere with keys of its own and a
    rect inside a translated group inside a group turning over the shutter
    (chains of depth 3 and 2)."""
    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.6, 0.6, 0.9)), bullseye=True))
    outer = tt.Group()
    outer.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    outer.transform.set_rotation(
        1.0, (np.cos(np.pi / 6), 0.0, np.sin(np.pi / 6), 0.0))
    inner = tt.Group()
    inner.transform.set_translation(0.0, (0.0, 0.5, 0.0))
    sph = tt.Sphere((0.0, 0.0, 0.0), 0.6, tt.DiffuseMaterial((0.3, 0.9, 0.3)))
    sph.transform.set_translation(0.0, (-2.5, 0.0, 1.0))
    sph.transform.set_translation(1.0, (-2.0, 0.0, 1.0))
    inner.add(sph)
    inner.add(tt.RectangleLight((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0),
                                (0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 5.0))
    outer.add(inner)
    s.add(outer)
    s.add(tt.Sphere((1.0, 0.0, 0.0), 0.5, tt.DiffuseMaterial((0.5, 0.5, 0.5))))
    return s


def _tied(n_more=0, moving=False):
    """Rows that tie exactly: two identical planes at y = -2, two identical
    spheres, a 16 x 16 rect lying on the planes (its unit normal is exact,
    so a ray going down meets all three at one t); ``n_more`` seeded
    spheres after the twins, every third moving where ``moving``."""
    rs = np.random.default_rng(8)
    s = tt.Scene()
    for c in ((0.7, 0.7, 0.9), (0.9, 0.2, 0.2)):
        s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                       tt.DiffuseMaterial(c), bullseye=True))
    for c in ((0.8, 0.3, 0.7), (0.2, 0.8, 0.3)):
        s.add(tt.Sphere((1.0, 0.0, 0.5), 1.0, tt.DiffuseMaterial(c)))
    for i in range(n_more):
        sph = tt.Sphere(tuple(rs.uniform(-7.0, 7.0, 3)),
                        float(rs.uniform(0.1, 0.3)),
                        tt.DiffuseMaterial((0.5, 0.5, 0.5)))
        if moving and i % 3 == 0:
            sph.transform.set_translation(0.0, (0.0, 0.0, 0.0))
            sph.transform.set_translation(1.0, tuple(rs.uniform(-1, 1, 3)))
        s.add(sph)
    s.add(tt.RectangleLight((-8.0, -2.0, -8.0), (16.0, 0.0, 0.0),
                            (0.0, 0.0, 16.0), (1.0, 1.0, 1.0), 2.0))
    return s


def _rows(sd):
    """[(kind, row, slot)] in the twin's fold order."""
    return [(k, r, s) for k, host in enumerate(
        (sd.pln_xf_host, sd.sph_xf_host, sd.rect_xf_host))
        for r, s in enumerate(host)]


def _spec_rows(specs):
    """[(kind, row, chain slots)] the launches hold, in launch order."""
    out = []
    for spec in specs:
        pos = 0
        for kind in range(3):
            for j in range(spec.count[kind]):
                c = spec.chain[pos]
                ch = spec.chains[c] if c >= 0 else None
                out.append((kind, spec.first[kind] + j, list(
                    spec.slots[ch.start:ch.start + ch.depth]) if ch else []))
                pos += 1
    return out


def _lanes(sd, seed=0, n=N):
    """Seeded rays from above the scene at points of it, lane times in
    [-0.5, 1.5] where it moves; lanes 0-7 NaN and infinite, 8-15 straight
    down from above the rect of ``_tied``."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-6.0, 4.0, -6.0], [6.0, 9.0, 12.0], (n, 3))
    d = rs.uniform([-7.0, -3.0, -7.0], [7.0, 3.0, 7.0], (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0:4] = np.float32([np.nan, np.inf, -np.inf, 0.0])[:, None]
    o[4:8, 1] = [np.nan, np.inf, -np.inf, 1e30]
    d[8:16] = [0.0, -1.0, 0.0]
    o[8:16] = rs.uniform([-5.0, 4.0, -5.0], [5.0, 9.0, 5.0], (8, 3))
    tmax = np.full(n, 1e30)
    tmax[::5] = rs.uniform(1.0, 12.0, tmax[::5].shape)
    tmax[8:16] = 1e30
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731,E501
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    time = f(rs.uniform(-0.5, 1.5, n)) if sd.has_motion else None
    return v3(o), v3(d), time, 1e-4, f(tmax)


# ------------------------------------------------------------ launch list


def test_spec_layout_is_the_kernels():
    """The ctypes spec has csrc/analytic_fold.cu's AfSpec layout (12
    int32, 128 int8 chain indices, 32 chains of a start and a depth, 256
    slots) and the pointer list its 36 slots (the card checks both against
    the library)."""
    assert ctypes.sizeof(tr._AfSpec) == 12 * 4 + 128 + 32 * 2 * 4 + 256 * 4
    assert (tr.AF_MAX_ROWS, tr.AF_MAX_CHAINS, tr.AF_MAX_SLOTS) == (128, 32,
                                                                  256)
    assert len(tr._AF_PTRS) == 36 and len(set(tr._AF_PTRS)) == 36
    assert tr._AF_PTRS[:16] == tr._AF_TABLES


@pytest.mark.parametrize("name", ["stage6", "stage5", "stage7", "stage7b",
                                  "nested", "spheres40_motion"])
def test_specs_hold_every_row_in_fold_order(standin, name):
    """One launch a query below the limits: every row in the twin's order,
    each keyed row's chain its slot's, outermost first (the slot itself
    last, each slot's parent before it); a static scene, and a row of slot
    0, has no chain; rows of one slot share one chain; the scene's
    constants ride along."""
    sd = {"stage6": lambda: demo.stage6_scene(standin),
          "stage5": demo.stage5_scene,
          "stage7": lambda: demo.stage7_scene1(standin),
          "stage7b": demo.stage7_scene2, "nested": _nested,
          "spheres40_motion": lambda: demo.many_spheres_scene(motion=True),
          }[name]().compile("cpu")
    (spec,) = tr._af_specs(sd)
    rows = _rows(sd)
    assert list(spec.count) == [sd.n_planes, sd.n_spheres, sd.n_rects]
    assert list(spec.first) == [0, 0, 0]
    assert (spec.sphere_id0, spec.rect_id0) == (sd.sphere_id0, sd.rect_id0)
    assert spec.k == sd.xf_times.shape[1]
    assert spec.motion == int(sd.has_motion)
    got = _spec_rows([spec])
    assert [(k, r) for k, r, _ in got] == [(k, r) for k, r, _ in rows]
    for (_, _, chain), (_, _, slot) in zip(got, rows):
        assert chain == xf.chain_slots(sd, slot)
        if chain:
            assert chain[-1] == slot and sd.has_motion
            assert all(sd.xf_parent_host[b] == a
                       for a, b in zip(chain, chain[1:]))
            assert sd.xf_parent_host[chain[0]] == -1
    slots = {s for _, _, s in rows if xf.chain_slots(sd, s)}
    assert spec.n_chain == len(slots)
    by_slot = {}
    for pos, (_, _, slot) in enumerate(rows):
        if slot in slots:
            assert by_slot.setdefault(slot, spec.chain[pos]) == spec.chain[pos]
        else:
            assert spec.chain[pos] == -1
    if name in ("stage6", "stage5"):
        assert not sd.has_motion and spec.n_chain == 0
    if name == "stage7":  # every shape keyed, each its own slot
        assert spec.n_chain == len(rows) == 7
    if name == "nested":
        depths = sorted(spec.chains[c].depth for c in range(spec.n_chain))
        assert depths == [2, 3]


@pytest.mark.parametrize("rows,chains,slots", [(3, 32, 256), (128, 2, 256),
                                               (5, 3, 256), (128, 32, 4)])
def test_specs_split_at_the_limits(monkeypatch, rows, chains, slots):
    """Past AF_MAX_ROWS rows, AF_MAX_CHAINS distinct chains or
    AF_MAX_SLOTS chain slots a launch ends and the next starts where it
    stopped; the launches hold every row once, in order, with the same
    chains."""
    sd = _tied(40, moving=True).compile("cpu")
    whole = _spec_rows(tr._af_specs(sd))
    monkeypatch.setattr(tr, "AF_MAX_ROWS", rows)
    monkeypatch.setattr(tr, "AF_MAX_CHAINS", chains)
    monkeypatch.setattr(tr, "AF_MAX_SLOTS", slots)
    specs = tr._af_specs(sd)
    assert _spec_rows(specs) == whole
    assert len(specs) > 1
    for spec in specs:
        assert 1 <= sum(spec.count) <= rows
        assert spec.n_chain <= chains and spec.n_slot <= slots


def test_past_128_rows_is_two_launches():
    """155 static rows (2 planes, 152 spheres, a rect): 128 in the first
    launch, the rest in the second, whose first sphere row is 126; with
    every third of the 150 seeded spheres moving (50 distinct chains) the
    first launch ends at its 32nd chain instead."""
    sd = _tied(150).compile("cpu")
    a, b = tr._af_specs(sd)
    assert list(a.count) == [2, 126, 0] and list(b.count) == [0, 26, 1]
    assert list(b.first)[1:] == [126, 0]
    specs = tr._af_specs(_tied(150, moving=True).compile("cpu"))
    assert [s.n_chain for s in specs] == [32, 18]
    assert list(specs[0].count) == [2, 98, 0]


def _deep(depth):
    """A sphere with keys of its own inside ``depth - 1`` nested groups,
    each translated over the shutter, over a plane."""
    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.6, 0.6, 0.9))))
    sph = tt.Sphere((0.0, 0.0, 0.0), 0.6, tt.DiffuseMaterial((0.3, 0.9, 0.3)))
    sph.transform.set_translation(0.0, (0.0, 0.0, 0.0))
    sph.transform.set_translation(1.0, (0.2, 0.0, 0.0))
    node = sph
    for g in range(depth - 1):
        group = tt.Group()
        group.transform.set_translation(0.0, (0.1, 0.0, 0.0))
        group.transform.set_translation(1.0, (0.1, 0.05 * g, 0.0))
        group.add(node)
        node = group
    s.add(node)
    return s


def test_chains_deeper_than_eight_fit_one_launch(monkeypatch):
    """A chain of 12 links (deeper than the shading's and the tiny-mesh
    fold's 8) is one launch; past AF_MAX_SLOTS links a chain raises, and a
    launch whose slot table is full ends."""
    sd = _deep(12).compile("cpu")
    (spec,) = tr._af_specs(sd)
    assert spec.n_chain == 1 and spec.chains[0].depth == spec.n_slot == 12
    assert _spec_rows([spec])[1][2] == xf.chain_slots(sd, sd.sph_xf_host[0])
    monkeypatch.setattr(tr, "AF_MAX_SLOTS", 11)
    with pytest.raises(ValueError, match="analytic_fold"):
        tr._af_specs(sd)
    nested = _nested().compile("cpu")  # chains of 3 and 2 links
    whole = _spec_rows(tr._af_specs(nested))
    monkeypatch.setattr(tr, "AF_MAX_SLOTS", 4)
    specs = tr._af_specs(nested)
    assert [s.n_slot for s in specs] == [3, 2]
    assert _spec_rows(specs) == whole


# ------------------------------------------------------------- refusals


def test_wrapper_refuses_what_it_cannot_launch():
    """Mixed devices, lanes not [N] f32, a time where the scene does not
    move and none where it does, each raise; the CPU takes the twin and
    counts no launch."""
    still = demo.stage5_scene().compile("cpu")
    moving = _nested().compile("cpu")
    o, d, _, tmin, tmax = _lanes(still)
    time = torch.zeros(N)
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tr.analytic_fold(still, o, d, None, tmin, tmax.to("meta"))
    with pytest.raises(ValueError, match="must be \\[N\\]"):
        tr.analytic_fold(still, o, d, None, tmin, tmax[:-1])
    with pytest.raises(ValueError, match="f32"):
        tr.analytic_fold(still, o, d, None, tmin, tmax.double())
    with pytest.raises(ValueError, match="where, and only where"):
        tr.analytic_fold(still, o, d, time, tmin, tmax)
    with pytest.raises(ValueError, match="where, and only where"):
        tr.analytic_fold(moving, o, d, None, tmin, tmax, any_hit=True)
    tr.analytic_fold(still, o, d, None, tmin, tmax)
    tr.analytic_fold(moving, o, d, time, tmin, tmax, any_hit=True)
    assert tr.analytic_fold.launches == 0


# ------------------------------------------------- the twin's contract


def _walk(sd, o, d, time, tmin, tmax):
    """The kernel's algorithm in plain PyTorch: every row in order, each in
    its local space, one at a time; the first of the least t wins. Returns
    (t, shape id, local ray and rotation of the winner are not needed)."""
    n = o.x.shape[0]
    t_best = torch.full((n,), float("inf"))
    sid = torch.full((n,), -1, dtype=torch.int32)
    tests = (tr._plane_rows, tr._sphere_rows,
             lambda *a: tr._rect_rows(*a)[0])
    id0 = (0, sd.sphere_id0, sd.rect_id0)
    for kind, row, slot in _rows(sd):
        o_l, d_l, _ = xf.local_ray(sd, slot, o, d, time)
        t = tests[kind](sd, row, row + 1, o_l, d_l, tmin, tmax)[0]
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        sid = torch.where(closer, id0[kind] + row, sid)
    return t_best, sid


@pytest.mark.parametrize("name", ["tied", "tied_moving", "nested",
                                  "deep", "stage7b"])
def test_twin_is_a_strict_walk_over_the_rows(name):
    """The plain twin's batched fold (argmin batches, kind by kind, then a
    strict < across kinds) equals a strict < walk over every row in order,
    t bit for bit and shape ids equal; any hit is "some row's t is
    finite"."""
    sd = {"tied": lambda: _tied(30), "tied_moving": lambda: _tied(30, True),
          "nested": _nested, "deep": lambda: _deep(12),
          "stage7b": demo.stage7_scene2}[name]()
    sd = sd.compile("cpu")
    args = _lanes(sd, seed=3)
    t, sid, *_ = tr.analytic_fold_plain(sd, *args)
    wt, wsid = _walk(sd, *args)
    assert torch.equal(t.view(torch.int32), wt.view(torch.int32))
    assert torch.equal(sid, wsid)
    assert int(torch.isfinite(t).sum()) > N // 4
    occ = tr.analytic_fold_plain(sd, *args, any_hit=True)
    assert torch.equal(occ, torch.isfinite(wt))


@pytest.mark.parametrize("moving", [False, True])
def test_ties_go_to_the_earlier_kind_and_the_lower_row(moving):
    """Rays straight down meet both planes and the rect at one t: the
    first plane takes them. Rays into the twin spheres take the first
    sphere. The second plane, the second sphere and (going down) the rect
    never win."""
    sd = _tied(30, moving).compile("cpu")
    o, d, time, tmin, tmax = _lanes(sd, seed=5)
    t, sid, mat, nrm, cmod = tr.analytic_fold_plain(sd, o, d, time, tmin,
                                                    tmax)
    down = d.y < 0.0
    assert torch.equal(sid[8:16], torch.zeros(8, dtype=torch.int32))
    assert int((sid == sd.sphere_id0).sum()) > 10
    assert not bool(((sid == 1) | (sid == sd.sphere_id0 + 1)
                     | ((sid == sd.rect_id0) & down)).any())
    assert bool((mat[sid == 0] == sd.pln_mat[0]).all())
    # the plane's own normal, rotated by the identity where the scene moves
    assert bool((nrm.y[sid == 0] == 1.0).all())
    assert bool(((cmod[sid == 0] == np.float32(0.2))
                 | (cmod[sid == 0] == 1.0)).all())


@pytest.mark.parametrize("name", ["tied", "nested"])
def test_nan_and_infinite_rays_keep_the_start(name):
    """NaN, infinite and zero directions and NaN, infinite and 1e30
    origins hit nothing: t = inf, shape and material -1, normal 0,
    color_mod 1, not occluded; a NaN or zero tmax hits nothing either."""
    sd = (_tied(3) if name == "tied" else _nested()).compile("cpu")
    o, d, time, tmin, tmax = _lanes(sd, seed=2)
    tmax[16:20] = torch.tensor([float("nan"), 0.0, -1.0, 1e-30])
    t, sid, mat, nrm, cmod = tr.analytic_fold_plain(sd, o, d, time, tmin,
                                                    tmax)
    occ = tr.analytic_fold_plain(sd, o, d, time, tmin, tmax, any_hit=True)
    for lanes in (slice(0, 8), slice(16, 20)):
        assert bool(torch.isinf(t[lanes]).all())
        assert bool((sid[lanes] == -1).all() and (mat[lanes] == -1).all())
        for c in (nrm.x, nrm.y, nrm.z):
            assert bool((c[lanes] == 0.0).all())
        assert bool((cmod[lanes] == 1.0).all()) and not bool(occ[lanes].any())
