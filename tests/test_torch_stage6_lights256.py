"""The benchmark configuration ``stage6_lights256`` (the stage-6 scene
under an office ceiling of 256 panel lights:
``portbench/configs/stage6_lights256.json``),
the shading's light table in the scene's device memory, and the analytic
fold's counters, on the CPU:

  * scenes of 65 sphere lights, of a light nested nine groups deep and
    of the 256-panel ceiling each build, and the bounce's shading wrappers
    hand the kernel the scene's light table and chain slots (one record a
    light: kind, row, chain depth and first slot, a mesh light's CDF run)
    and a spec of the launch's constants alone;
  * the configuration is ``stage6_bumpy`` with its two lights replaced by
    the ceiling: the same camera, materials, meshes and shapes, 256 rect
    lights of 2 x 2 units, one centred in each 5-unit module of a 16 x 16
    grid at y = 7, 261 analytic rows a query in three chained
    ``analytic_fold`` launches;
  * ``portbench/run.py`` ``main`` runs the configuration on the n = 8
    stand-in at a tiny traffic on a copy of the checkout and is
    ``correct`` against the plain reference; the reference in bfloat16 is
    not;
  * with tracing on, the analytic fold's twin counts each query's lanes
    and its row tests by kind: rows x lanes on a closest-hit query, each
    lane's rows up to its first hit on an any-hit one; nothing is counted
    with tracing off;
  * ``portbench/rooflines/analytic_fold.py``'s arithmetic and the two new
    readers on a synthetic trace, and None before their counters exist.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import port_scene, spec, standin  # noqa: E402
from portbench.rooflines import analytic_fold as roof  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from rayito_tpu_torch.models import demo  # noqa: E402
from rayito_tpu_torch.models.camera import PerspectiveCamera  # noqa: E402
from rayito_tpu_torch.models.scene import (  # noqa: E402
    LIGHT_RECT, LIGHT_SPHERE)
from rayito_tpu_torch.ops import transform as xf  # noqa: E402
from rayito_tpu_torch.ops.vec3 import V3  # noqa: E402
from rayito_tpu_torch.render import pathtracer as pt  # noqa: E402
from rayito_tpu_torch.render import shade  # noqa: E402
from rayito_tpu_torch.render import trace as tr  # noqa: E402
from rayito_tpu_torch.utils import tracing  # noqa: E402
from rayito_tpu_torch.utils.config import RenderConfig  # noqa: E402

CONFIG = os.path.join(ROOT, "portbench", "configs", "stage6_lights256.json")
BUMPY = os.path.join(ROOT, "portbench", "configs", "stage6_bumpy.json")
CPU = torch.device("cpu")
TMIN = 1e-4


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.enable(False)
    tracing.reset()


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def obj8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    standin.write_bumpy_standin(path, n=8)
    return path


@pytest.fixture(scope="module")
def scenes(obj8):
    """The three scenes past the card's old limits, compiled on the CPU."""
    return {
        "lights65": demo.many_sphere_lights_scene().compile(CPU),
        "deep9": demo.deep_light_scene().compile(CPU),
        "rig256": port_scene.build(_load(CONFIG), {"bumpy": obj8}).compile(
            CPU),
    }


# ------------------------------------------------ the light table


def _first_bounce_args(scene, cam):
    """The (prepare, resolve) arguments of the first bounce of one eager
    8x8 pass at 2 pixel samples, as the path hands them."""
    cfg = RenderConfig(width=8, height=8, pixel_samples=2, light_samples=1,
                       max_depth=1, max_rays_per_pass=128)
    got = []
    prep, res = shade.bounce_prepare, shade.bounce_resolve

    def spy_prep(*a):
        got.append([list(a), None])
        return prep(*a)

    def spy_res(*a):
        if got[-1][1] is None:
            got[-1][1] = list(a)
        return res(*a)

    shade.bounce_prepare, shade.bounce_resolve = spy_prep, spy_res
    try:
        pt._path_pass_body(scene, cfg, cam,
                           torch.arange(2, dtype=torch.int32),
                           torch.zeros((), dtype=torch.int32), 8)
    finally:
        shade.bounce_prepare, shade.bounce_resolve = prep, res
    return got[0]


def _records(scene):
    """Each light's record, worked out from the scene's host tables."""
    rows = {LIGHT_RECT: scene.rect_xf_host, LIGHT_SPHERE: scene.sph_xf_host}
    out, n = [], 0
    for kind, idx in zip(scene.light_kinds_host, scene.light_indices_host):
        chain = xf.chain_slots(scene, rows[kind][idx])
        out.append([kind, idx, len(chain), n, 0, 0, 0])
        n += len(chain)
    return out


@pytest.mark.parametrize("name", ["lights65", "deep9", "rig256"])
def test_the_wrappers_hand_the_kernel_the_scenes_light_table(scenes, name,
                                                             monkeypatch):
    scene = scenes[name]
    want_lights = {"lights65": 65, "deep9": 2, "rig256": 256}[name]
    assert scene.n_lights == want_lights
    assert tuple(scene.light_table.shape) == (want_lights,
                                              len(shade.LIGHT_FIELDS))
    assert scene.light_table.dtype == scene.light_slots.dtype == torch.int32
    assert scene.light_table.tolist() == _records(scene)
    chains = [xf.chain_slots(scene, scene.sph_xf_host[i]) for k, i in zip(
        scene.light_kinds_host, scene.light_indices_host)
        if k == LIGHT_SPHERE]
    assert scene.light_slots.tolist() == [s for c in chains for s in c]
    if name == "deep9":
        assert len(chains[0]) == 9 and scene.has_motion
    # the spec holds the launch's constants alone: no light, no slot
    assert [f for f, _ in shade._ShadeSpec._fields_] == [
        "n_lights", "nls", "k", "bounce", "analytic", "motion", "tmin",
        "light_scale"]
    cam = (PerspectiveCamera.make(30.0, (-2.0, 5.0, 15.0), (0, 0, 0),
                                  (0, 1, 0)) if name == "rig256" else
           PerspectiveCamera.make(40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0)))
    args, res_args = _first_bounce_args(scene, cam)
    launched = []
    monkeypatch.setattr(shade.cuda_lib, "on_cpu", lambda *a: False)
    monkeypatch.setattr(shade, "_launch", lambda fn, spec, ptrs, n, r:
                        launched.append((fn, spec, ptrs, n, r)))
    res_args[2] = shade.bounce_prepare(*args)
    shade.bounce_resolve(*res_args)
    assert [(fn.__name__, r) for fn, _, _, _, r in launched] == [
        ("bounce_prepare", 0), ("bounce_resolve", 1)]
    for _, sp, ptrs, n, _ in launched:
        assert ptrs["light_table"] is scene.light_table
        assert ptrs["light_slots"] is scene.light_slots
        assert (sp.n_lights, sp.nls, sp.analytic, sp.motion) == (
            want_lights, 1, 1, int(scene.has_motion))
        assert sp.light_scale == float(want_lights) and n == 128


def test_a_mesh_lights_record_holds_its_cdf_run():
    """The box mesh light (the last mesh): its record's run is its own
    48-padded triangles and its padded cluster count, as
    ``render/lights.py`` searches them."""
    import rayito_tpu_torch as tt

    s = tt.Scene()
    s.add(tt.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.7, 0.7, 0.8))))
    s.add(tt.ShapeLight(demo.inline_box_mesh(tt.DiffuseMaterial(
        (0.9, 0.9, 0.9))), color=(1.0, 1.0, 1.0), power=8.0))
    scene = s.compile(CPU)
    (rec,) = scene.light_table.tolist()
    tri0, count = scene.mesh_tri_ranges[0]
    assert rec == [2, 0, 0, 0, tri0, min(48, scene.tri_area_cdf.shape[0]
                                         - tri0),
                   scene.mesh_cl_ranges[0][1] * 48]
    assert not shade.analytic_lights(scene)


# ------------------------------------------------ the configuration


def test_the_configuration_is_stage6_bumpy_under_the_rig(scenes):
    cfg, base = _load(CONFIG), _load(BUMPY)
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    for k in ("camera", "materials", "meshes"):
        assert cfg[k] == base[k], k
    lights = ("rect_light", "sphere_light")
    assert cfg["shapes"][:7] == [s for s in base["shapes"]
                                 if s["type"] not in lights]
    rig = cfg["shapes"][7:]
    assert len(rig) == 256
    # an 80 x 80-unit floor (24 x 24 m at 0.3 m a unit) of 5-unit modules
    # (the 1.5 m planning grid), a 2 x 2 panel (600 mm) centred in each,
    # facing down from the ceiling at y = 7 (2.7 m above the floor)
    for k, s in enumerate(rig):
        j, i = divmod(k, 16)
        assert s == {"type": "rect_light",
                     "corner": [-38.5 + 5 * i, 7.0, -38.5 + 5 * j],
                     "side1": [2.0, 0.0, 0.0], "side2": [0.0, 0.0, 2.0],
                     "color": [1.0, 1.0, 1.0], "power": 5.0}
    centres = {(s["corner"][0] + 1.0, s["corner"][2] + 1.0) for s in rig}
    assert centres == {(-37.5 + 5 * i, -37.5 + 5 * j) for i in range(16)
                       for j in range(16)}
    # stage 6's own rect light's color and power
    rect = next(s for s in base["shapes"] if s["type"] == "rect_light")
    assert (rig[0]["color"], rig[0]["power"]) == (rect["color"],
                                                  rect["power"])
    assert any("planning grid" in a for a in cfg["assumed"])
    s = scenes["rig256"]
    assert (s.n_planes, s.n_spheres, s.n_rects, s.n_lights) == (1, 4, 256,
                                                                256)
    assert not s.has_motion and shade.analytic_lights(s)
    specs = tr._af_specs(s)
    assert [sum(sp.count) for sp in specs] == [128, 128, 5]


def _copy_checkout(root, n: int):
    """A copy of the benchmark with the configuration's stand-in at ``n``
    and a tiny traffic of two bands a pass."""
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    cfg_path = root / "portbench" / "configs" / "stage6_lights256.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["meshes"]["bumpy"]["n"] = n
    cfg_path.write_text(json.dumps(cfg))
    tiny = {"why": "a test frame", "loop": "closed", "users": 1,
            "width": 16, "height": 8, "pixel_samples": 2,
            "light_samples": 1, "max_depth": 3, "max_rays_per_pass": 64}
    (root / "portbench" / "traffic" / "tiny_test.json").write_text(
        json.dumps(tiny))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stage6_lights256.tiny_test",
                               "config": "stage6_lights256",
                               "traffic": "tiny_test", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_the_run_on_the_cpu_is_correct(tmp_path):
    root = tmp_path / "checkout"
    _copy_checkout(root, 8)
    # a process of its own (the program from this checkout, the benchmark
    # from the copy): the run refuses to report where a module of JAX is
    # loaded
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; "
            "sys.exit(run.main(sys.argv[3:], device='cpu', root=sys.argv[1], "
            "here=sys.argv[2]))")
    out = subprocess.run(
        [sys.executable, "-c", code, str(root), str(root / "portbench"),
         "--workload", "stage6_lights256.tiny_test", "--seed",
         str(2**31 + 25), "--seconds", "0.05", "--trace", "0"],
        cwd=str(root), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["mismatch_share"]["value"] <= 0.01
    assert set(res["metrics"]) == {"msamples_per_s", "pass_ms_p95",
                                   "setup_s"}


def test_the_control_in_bfloat16_fails_the_comparison(obj8):
    """The reference in bfloat16 against itself in float32 on this scene:
    far past the mismatch limit, so a render in a lower precision than the
    configuration's float32 is not ``correct``."""
    from portbench import compare
    from portbench.reference import scene as rscene
    from portbench.reference import tracer

    cfg = _load(CONFIG)
    flat = rscene.flatten(cfg, {"bumpy": obj8})
    rc = dict(width=16, height=8, pixel_samples=2, light_samples=1,
              max_depth=3, seed=2**31 + 31)
    pix = np.arange(16 * 8)
    ref = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu")
    low = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu",
                               torch.bfloat16)
    assert compare.mismatch_share(low, ref) > 3 * compare.MISMATCH_LIMIT


# ------------------------------------------------ the fold's counters


def _rays(n, seed):
    """Seeded rays from around the camera and from the floor: some reach
    the rig, some the spheres, some the plane, some nothing."""
    rs = np.random.default_rng(seed)
    org = np.where(rs.uniform(size=(n, 1)) < 0.5, [[-2.0, 5.0, 15.0]],
                   rs.uniform([-6, -1.9, -6], [6, 0, 6], (n, 3)))
    tgt = rs.uniform([-12, -3, -12], [12, 9, 6], (n, 3))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    o = V3(*(f(org[:, k]) for k in range(3)))
    d = V3(*(f(tgt[:, k] - org[:, k]) for k in range(3)))
    tmax = f(np.where(rs.uniform(size=n) < 0.3, rs.uniform(0.5, 20.0, n),
                      1e30))
    return o, d, tmax


def _counters():
    return {k: v for k, v in tracing.snapshot().counters.items()
            if k.startswith("analytic_fold.")}


def test_the_counters_are_the_twins_rows_and_lanes(scenes):
    s = scenes["rig256"]
    n = 500
    o, d, tmax = _rays(n, 7)
    tr.analytic_fold(s, o, d, None, TMIN, tmax)
    tr.analytic_fold(s, o, d, None, TMIN, tmax, any_hit=True)
    assert _counters() == {}  # tracing off: nothing
    tracing.enable(True)
    tracing.reset()
    best = tr.analytic_fold(s, o, d, None, TMIN, tmax)
    assert _counters() == {"analytic_fold.lanes.closest": n,
                           "analytic_fold.tests.plane": n * 1,
                           "analytic_fold.tests.sphere": n * 4,
                           "analytic_fold.tests.rect": n * 256}
    tracing.reset()
    occ = tr.analytic_fold(s, o, d, None, TMIN, tmax, any_hit=True)
    got = _counters()
    # each lane's rows in the fold's order up to its first hit
    hits = torch.cat([torch.isfinite(t) for t in (
        tr._plane_rows(s, 0, 1, o, d, TMIN, tmax),
        tr._sphere_rows(s, 0, 4, o, d, TMIN, tmax),
        tr._rect_rows(s, 0, 256, o, d, TMIN, tmax)[0])])
    assert torch.equal(occ, hits.any(0))
    assert 50 < int(occ.sum()) < n - 50
    assert int((torch.isfinite(best[0]) & (best[0] < tmax)).sum()) > 50
    want = {"plane": 0, "sphere": 0, "rect": 0}
    bounds = {"plane": (0, 1), "sphere": (1, 5), "rect": (5, 261)}
    for lane in range(n):
        rows = torch.nonzero(hits[:, lane]).flatten().tolist()
        stop = rows[0] + 1 if rows else 261
        for kind, (a, b) in bounds.items():
            want[kind] += max(0, min(stop, b) - a)
    assert got == {"analytic_fold.lanes.any": n,
                   **{f"analytic_fold.tests.{k}": v
                      for k, v in want.items()}}
    assert sum(want.values()) < 261 * n


def test_a_traced_pass_counts_every_query(scenes):
    """A traced stage-6 pass under the ceiling: every query's lanes counted
    once, each closest-hit lane's 261 rows, an any-hit lane's fewer."""
    s = scenes["rig256"]
    cfg = RenderConfig(width=8, height=8, pixel_samples=2, light_samples=1,
                       max_depth=2, max_rays_per_pass=128)
    cam = PerspectiveCamera.make(30.0, (-2.0, 5.0, 15.0), (0, 0, 0),
                                 (0, 1, 0))
    with tracing.on():
        tracing.reset()
        _, _, queries = pt._path_pass_body(
            s, cfg, cam, torch.arange(2, dtype=torch.int32),
            torch.zeros((), dtype=torch.int32), 8)
        c = tracing.snapshot().counters
    # every lane of a query, live or not: a closest-hit query and, at one
    # light sample, two any-hit queries a bounce
    closest = c["analytic_fold.lanes.closest"]
    assert closest == 128 * cfg.max_depth
    assert c["analytic_fold.lanes.any"] == 2 * closest
    assert int(queries) < 3 * closest
    assert c["analytic_fold.tests.plane"] >= closest
    tests = sum(c[f"analytic_fold.tests.{k}"] for k in tr.AF_KINDS)
    assert 261 * closest < tests < 261 * 3 * closest


# ------------------------------------------------ roofline and readers


def test_roofline_arithmetic_on_hand_counted_inputs():
    c = {"analytic_fold.tests.plane": 100, "analytic_fold.tests.sphere": 200,
         "analytic_fold.tests.rect": 300, "analytic_fold.lanes.closest": 10,
         "analytic_fold.lanes.any": 20}
    assert roof.instructions(c) == 100 * 36 + 200 * 65 + 300 * 156
    # o, d, tmax (and time) in; t, id, material, normal, color_mod out, or
    # one occlusion byte
    assert roof.lane_bytes("closest", False) == 28 + 28
    assert roof.lane_bytes("closest", True) == 32 + 28
    assert roof.lane_bytes("any", False) == 29
    assert roof.nbytes(c, False) == 10 * 56 + 20 * 29
    assert roof.least_seconds(c, False) == pytest.approx(
        63400 / roof.PEAK_ISSUE)
    few = {"analytic_fold.tests.plane": 1, "analytic_fold.lanes.any": 1000}
    assert roof.least_seconds(few, True) == pytest.approx(
        1000 * 33 / roof.PEAK_BYTES_PER_S)


def _ctx(counters):
    """A traced render with two fold launches of 30 and 10 us."""
    from portbench import trace as ptrace

    kern = ("void (anonymous namespace)::analytic_fold_kernel<false, "
            "false>((anonymous namespace)::AfSpec, int)")
    trace = Trace(lo=0.0, hi=1000.0,
                  kernels=[(kern, 100.0, 30.0), ("other", 200.0, 5.0),
                           (kern.replace("<false", "<true"), 300.0, 10.0)],
                  copies=[], runtime=[], host=[], passes=4)
    return types.SimpleNamespace(
        trace=trace, span_trace=trace, spans=[], counters=counters,
        scene={"motion": False}, kernel_id=ptrace.kernel_id,
        roofline=lambda name: roof)


def test_readers_on_a_synthetic_trace():
    c = {"analytic_fold.tests.plane": 100, "analytic_fold.tests.sphere": 200,
         "analytic_fold.tests.rect": 300, "analytic_fold.lanes.closest": 10,
         "analytic_fold.lanes.any": 20}
    read = lambda name: spec.metric_reader(name)(_ctx(c))  # noqa: E731
    assert read("analytic_tests_per_ray") == pytest.approx(20.0)
    assert read("analytic_fold_roofline") == pytest.approx(
        100.0 * 63400 / roof.PEAK_ISSUE / 40e-6)


def test_readers_find_nothing_before_their_counters():
    """The parent's program: a fold in the trace, no analytic_fold
    counters."""
    names = ("analytic_tests_per_ray", "analytic_fold_roofline")
    ctx = _ctx({"fold_small.tests.closest": 3})
    assert [spec.metric_reader(m)(ctx) for m in names] == [None] * 2
    ctx = types.SimpleNamespace(trace=Trace(lo=0.0, hi=1.0, kernels=[],
                                            copies=[], runtime=[], host=[],
                                            passes=1))
    assert [spec.metric_reader(m)(ctx) for m in names] == [None] * 2
