"""The benchmark configuration ``stage7_tumbling`` (Rayito's stage-7 demo
scene 2 written out as data, ``portbench/configs/stage7_tumbling.json``)
and what its cell reads of the tiny-mesh fold, on the CPU:

  * the configuration, built through ``portbench/port_scene.py``, compiles
    to arrays bit-identical to ``models/demo.py`` ``stage7_scene2``'s;
  * ``portbench/run.py`` ``main`` runs the configuration at a tiny traffic
    of two samples a launch on a copy of the checkout and is ``correct``
    against the plain reference; the reference in bfloat16 is not;
  * the plain twin ``fold_small_query_plain`` counts what the kernel
    counts with tracing on: every row of every cube a lane on a
    closest-hit query, a lane's rows up to its first hit on an any-hit one
    (held against a walk of the dense t matrix), the chain links of the
    meshes a lane reaches, the lanes of each kind; nothing with tracing
    off;
  * every ``fold_small`` call of a traced pass lies inside a
    ``tiny_mesh_fold`` device span, on the closest-hit and the any-hit
    path;
  * a tiny mesh nested nine groups deep (past the 8 links a mesh once
    held) goes to the kernel, its chain in the launch's slot table; the
    links cut a query's launches, and a chain past the table is refused;
  * ``portbench/rooflines/fold_small.py``'s arithmetic and the three new
    readers on hand-counted inputs.
"""

import dataclasses
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

from portbench import port_scene, spec  # noqa: E402
from portbench.rooflines import fold_small as roof  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from rayito_tpu_torch.models import demo
from rayito_tpu_torch.ops import transform as xf
from rayito_tpu_torch.ops.intersect import triangle_intersect
from rayito_tpu_torch.ops.quaternion import Quat
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import mesh_intersect as mi
from rayito_tpu_torch.utils import cuda_lib, tracing

CONFIG = os.path.join(ROOT, "portbench", "configs", "stage7_tumbling.json")
CPU = torch.device("cpu")
TMIN = 1e-4


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.enable(False)
    tracing.reset()


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _bits(x):
    x = x.detach().cpu()
    if x.dtype == torch.bool:
        return x.numpy()
    return x.contiguous().view(torch.uint8).numpy()


def test_configuration_compiles_to_the_demo_scene_bit_for_bit():
    got = port_scene.build(_config(), {}).compile(CPU)
    want = demo.stage7_scene2().compile(CPU)
    assert got.ktab_small == tuple(range(10)) and not got.ktab_xf
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(_bits(a), _bits(b)), f.name
        else:
            assert a == b, f.name


def test_the_run_on_the_cpu_is_correct_at_two_samples_a_launch(tmp_path):
    """A copy of the checkout with a tiny traffic whose launch budget holds
    the frame twice: two passes a render, each of two samples."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    tiny = {"why": "a test frame", "loop": "closed", "users": 1,
            "width": 24, "height": 16, "pixel_samples": 2,
            "light_samples": 1, "max_depth": 3, "max_rays_per_pass": 768}
    (root / "portbench" / "traffic" / "tiny_test.json").write_text(
        json.dumps(tiny))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stage7_tumbling.tiny_test",
                               "config": "stage7_tumbling",
                               "traffic": "tiny_test", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # a process of its own (the program from this checkout, the benchmark
    # from the copy): the run refuses to report where a module of JAX is
    # loaded, as it is in this one
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; "
            "sys.exit(run.main(sys.argv[3:], device='cpu', root=sys.argv[1], "
            "here=sys.argv[2]))")
    out = subprocess.run(
        [sys.executable, "-c", code, str(root), str(root / "portbench"),
         "--workload", "stage7_tumbling.tiny_test", "--seed",
         str(2**31 + 5), "--seconds", "0.05", "--trace", "0"],
        cwd=str(root), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["mismatch_share"]["value"] <= 0.01
    assert set(res["metrics"]) == {"msamples_per_s", "pass_ms_p95",
                                   "setup_s"}


def test_the_control_in_bfloat16_fails_the_comparison():
    """The reference in bfloat16 against itself in float32 on this scene:
    far past the mismatch limit, so a render in a lower precision than the
    configuration's float32 is not ``correct``."""
    from portbench import compare
    from portbench.reference import scene as rscene
    from portbench.reference import tracer

    cfg = _config()
    flat = rscene.flatten(cfg, {})
    rc = dict(width=32, height=16, pixel_samples=2, light_samples=1,
              max_depth=3, seed=2**31 + 17)
    pix = np.arange(32 * 16)
    ref = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu")
    low = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu",
                               torch.bfloat16)
    assert compare.mismatch_share(low, ref) > 3 * compare.MISMATCH_LIMIT


# ------------------------------------------------ the plain twin's counters


def _rays(n=2048, seed=4):
    """Seeded rays from stage 7b's camera at the cubes, lane times in
    [-0.5, 1.5], every 7th cut short."""
    rs = np.random.default_rng(seed)
    o = np.tile(np.float32([-4.0, 10.0, 30.0]), (n, 1))
    target = np.stack([rs.uniform(-10.0, 11.0, n), rs.uniform(-2.0, 11.0, n),
                       rs.uniform(1.0, 4.0, n)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30)
    tmax[::7] = 28.0
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    return v3(o), v3(d), f(rs.uniform(-0.5, 1.5, n)), f(tmax)


def _best(n):
    z = torch.zeros(n)
    return (torch.full((n,), float("inf")),
            torch.full((n,), -1, dtype=torch.int32), z, z.clone(),
            Quat(torch.ones(n), V3(z.clone(), z.clone(), z.clone())))


@pytest.fixture(scope="module")
def s7b():
    return demo.stage7_scene2().compile(CPU)


def _counted(fn):
    with tracing.on():
        tracing.reset()
        out = fn()
        c = tracing.counters()
        tracing.reset()
    return out, c


def test_closest_hit_counts_every_row_and_link(s7b):
    o, d, time, tmax = _rays()
    n = tmax.shape[0]
    depth = [len(xf.chain_slots(s7b, s7b.mesh_xf_host[m]))
             for m in s7b.ktab_small]
    assert depth == [1] * 10
    out, c = _counted(lambda: mi.fold_small_query_plain(
        s7b, o, d, time, TMIN, tmax, best=_best(n)))
    assert c == {"fold_small.lanes.closest": n, "fold_small.links": n * 10,
                 "fold_small.tests.closest": n * 120}
    plain = mi.fold_small_query_plain(s7b, o, d, time, TMIN, tmax,
                                      best=_best(n))
    assert all(torch.equal(a, b) for a, b in zip(out[:4], plain[:4]))
    assert int((out[1] >= 0).sum()) > n // 20


def _first_hits(scene, o, d, time, tmax, occluded):
    """(tests, links) of an any-hit query, walked lane by lane: meshes in
    order until the lane is occluded, each mesh's rows up to its first hit
    (t finite) in row order."""
    occ = occluded.numpy().copy()
    tests = links = 0
    for m in scene.ktab_small:
        o_l, d_l, _ = xf.local_ray(scene, scene.mesh_xf_host[m], o, d, time)
        row0, count = scene.mesh_tri_ranges[m]
        rows = scene.tri_vert_rows[row0:row0 + count]
        vert = lambda k: V3(rows[None, :, k], rows[None, :, k + 1],  # noqa
                            rows[None, :, k + 2])
        t = triangle_intersect(o_l[:, None], d_l[:, None], TMIN,
                               tmax[:, None], vert(0), vert(3), vert(6))[0]
        hit = np.isfinite(t.numpy())
        for lane in np.flatnonzero(~occ):
            rows_hit = np.flatnonzero(hit[lane])
            tests += int(rows_hit[0]) + 1 if len(rows_hit) else count
            links += len(xf.chain_slots(scene, scene.mesh_xf_host[m]))
        occ |= hit.any(1)
    return tests, links, occ


def test_any_hit_counts_to_the_first_hit(s7b):
    o, d, time, tmax = _rays(seed=6)
    n = tmax.shape[0]
    start = torch.zeros(n, dtype=torch.bool)
    start[::11] = True  # lanes occluded before the fold test nothing
    occ, c = _counted(lambda: mi.fold_small_query_plain(
        s7b, o, d, time, TMIN, tmax, occluded=start.clone()))
    tests, links, want = _first_hits(s7b, o, d, time, tmax, start)
    assert np.array_equal(occ.numpy(), want)
    assert c == {"fold_small.lanes.any": n, "fold_small.links": links,
                 "fold_small.tests.any": tests}
    assert tests < n * 120 and links < n * 10
    assert int(occ.sum()) > int(start.sum())


def test_chained_launches_count_their_lanes(s7b, monkeypatch):
    o, d, time, tmax = _rays(n=256)
    monkeypatch.setattr(mi, "FOLD_MAX_MESHES", 3)
    assert [len(c) for c in mi._launch_cuts(s7b)] == [3, 3, 3, 1]
    _, c = _counted(lambda: mi.fold_small_query_plain(
        s7b, o, d, time, TMIN, tmax, best=_best(256)))
    assert c["fold_small.lanes.closest"] == 4 * 256
    assert c["fold_small.tests.closest"] == 256 * 120


def test_nothing_is_counted_with_tracing_off(s7b):
    o, d, time, tmax = _rays(n=128)
    tracing.reset()
    mi.fold_small_query_plain(s7b, o, d, time, TMIN, tmax, best=_best(128))
    mi.fold_small_query_plain(s7b, o, d, time, TMIN, tmax,
                              occluded=torch.zeros(128, dtype=torch.bool))
    assert not any(k.startswith("fold_small.")
                   for k in tracing.counters())


def test_every_fold_call_of_a_pass_is_inside_a_tiny_mesh_fold_span(
        s7b, monkeypatch):
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import trace as ttrace
    from rayito_tpu_torch.utils.config import RenderConfig

    seen = []
    real = ttrace.fold_small

    def spy(scene, o, d, time, tmin, tmax, best=None, occluded=None):
        seen.append(("closest" if best is not None else "any",
                     tracing._stack[-1].name if tracing._stack else None))
        return real(scene, o, d, time, tmin, tmax, best, occluded)

    monkeypatch.setattr(ttrace, "fold_small", spy)
    cfg = RenderConfig(width=12, height=8, pixel_samples=1, light_samples=1,
                       max_depth=2, max_rays_per_pass=96, seed=3)
    cam = PerspectiveCamera.make(30.0, *demo.STAGE7_SCENE2_CAMERA,
                                 focal_distance=16.0, lens_radius=0.0,
                                 shutter_open=0.0, shutter_close=1.0)
    si = torch.zeros(1, dtype=torch.int32)
    row0 = torch.zeros((), dtype=torch.int32)
    with tracing.on():
        pt._path_pass_body(s7b, cfg, cam, si, row0, 8)
        tracing.reset()
    assert {k for k, _ in seen} == {"closest", "any"}
    assert all(span == "tiny_mesh_fold" for _, span in seen)


# ------------------------------------------------ chains in the slot table


@pytest.fixture(scope="module")
def deep():
    return demo.deep_cube_scene(9).compile(CPU)


def test_a_nine_link_chain_goes_to_the_kernel(deep, s7b, monkeypatch):
    """Nine links (past the 8 a mesh once held): the launch's slot table
    holds the chain outermost first, and with the tensors on a card the
    wrapper hands that spec to the kernel (here a stand-in library that
    records it), closest and any hit. The links cut a query's launches;
    a chain past the table is refused."""
    chain = mi._chain(deep, deep.ktab_small[0])
    assert len(chain) == 9
    (spec,) = mi._fold_specs(deep)
    m = spec.mesh[0]
    assert (spec.n_mesh, spec.n_link, m.link0, m.depth) == (1, 9, 0, 9)
    assert list(spec.slots[:9]) == chain
    seen = []

    class Lib:
        def rt_fold_small(self, spec_ref, *args):
            s = spec_ref._obj
            seen.append(list(s.slots[:s.n_link]))
            return 0

    monkeypatch.setattr(cuda_lib, "on_cpu", lambda *a: False)
    monkeypatch.setattr(cuda_lib, "launch_args", lambda *a: (Lib(), None))
    o, d, time, tmax = _rays(n=64)
    mi.fold_small(deep, o, d, time, TMIN, tmax, best=_best(64))
    mi.fold_small(deep, o, d, time, TMIN, tmax,
                  occluded=torch.zeros(64, dtype=torch.bool))
    assert seen == [chain, chain]
    monkeypatch.setattr(mi, "FOLD_MAX_LINKS", 4)
    assert [len(c) for c in mi._launch_cuts(s7b)] == [4, 4, 2]
    assert [s.n_link for s in mi._fold_specs(s7b)] == [4, 4, 2]
    with pytest.raises(ValueError, match="chain of 9"):
        mi._launch_cuts(deep)


# ------------------------------------------------ roofline and readers


def test_roofline_arithmetic_on_hand_counted_inputs():
    cfg = _config()
    assert roof.keyed(cfg)
    c = {"fold_small.tests.closest": 1200, "fold_small.tests.any": 600,
         "fold_small.links": 150, "fold_small.lanes.closest": 10,
         "fold_small.lanes.any": 10}
    # 1,200 x 84 + 600 x 83 + 150 x (69 + 47)
    assert roof.instructions(c, True) == pytest.approx(168000.0)
    assert roof.instructions(c, False) == pytest.approx(160950.0)
    # a closest-hit lane: o, d, tmax, time, then t, prim, beta, gamma and
    # the rotation read and written; an any-hit lane one byte each way
    assert roof.lane_bytes("closest", True) == 32 + 2 * 32
    assert roof.lane_bytes("any", True) == 32 + 2
    assert roof.lane_bytes("closest", False) == 28 + 2 * 16
    # 10 closest-hit lanes, 10 any-hit lanes
    assert roof.nbytes(c, True) == 10 * 96 + 10 * 34
    assert roof.nbytes(c, False) == 10 * 60 + 10 * 30
    assert roof.least_seconds(c, cfg, True) == pytest.approx(
        168000.0 / roof.PEAK_ISSUE)
    static = dict(cfg, shapes=[dict(s, transform={"times": [0.0]})
                               for s in cfg["shapes"]])
    assert not roof.keyed(static)


def _span(i, name, start, end, kind="device"):
    return types.SimpleNamespace(id=i, name=name, kind=kind, start=start,
                                 end=end)


def _ctx(counters):
    """A span render of one render of four samples (two launches of two):
    two tiny-mesh folds of 30 and 50 us, a 40-us fold kernel in the traced
    render's trace."""
    kern = "void (anonymous namespace)::fold_small_kernel<false, false>(int)"
    tr = Trace(lo=0.0, hi=1000.0,
               kernels=[(kern, 310.0, 40.0), ("other", 500.0, 10.0)],
               copies=[], runtime=[], host=[], passes=4)
    spans = [_span(1, "mesh", 200.0, 390.0),
             _span(2, "tiny_mesh_fold", 300.0, 380.0),
             _span(3, "tiny_mesh_fold", 600.0, 700.0)]
    sp_tr = Trace(lo=0.0, hi=1000.0,
                  kernels=[(kern, 310.0, 30.0), (kern, 610.0, 50.0),
                           ("other", 800.0, 5.0)],
                  copies=[], runtime=[], host=[], passes=4)
    from portbench import trace as ptrace

    return types.SimpleNamespace(
        trace=tr, span_trace=sp_tr, spans=spans, counters=counters,
        config=_config(), scene={"motion": True},
        kernel_id=ptrace.kernel_id,
        roofline=lambda name: roof)


def test_readers_on_a_synthetic_span_render():
    c = {"fold_small.tests.closest": 1200, "fold_small.tests.any": 600,
         "fold_small.links": 150, "fold_small.lanes.closest": 10,
         "fold_small.lanes.any": 10}
    ctx = _ctx(c)
    read = lambda name: spec.metric_reader(name)(ctx)  # noqa: E731
    assert read("tiny_tests_per_ray") == pytest.approx(90.0)
    # 80 us over the render's four samples, the harness's passes
    assert read("tiny_fold_ms_per_pass") == pytest.approx(0.02)
    assert read("tiny_fold_roofline") == pytest.approx(
        100.0 * 168000.0 / roof.PEAK_ISSUE / 40e-6)


def test_readers_find_nothing_before_the_counters():
    """The parent's program: spans, but no fold_small counters."""
    ctx = _ctx({"traverse.pairs": 3})
    read = lambda name: spec.metric_reader(name)(ctx)  # noqa: E731
    assert read("tiny_tests_per_ray") is None
    assert read("tiny_fold_roofline") is None
    assert read("tiny_fold_ms_per_pass") == pytest.approx(0.02)
    ctx = types.SimpleNamespace(trace=Trace(lo=0.0, hi=1.0, kernels=[],
                                            copies=[], runtime=[], host=[],
                                            passes=1))
    assert [spec.metric_reader(m)(ctx) for m in (
        "tiny_tests_per_ray", "tiny_fold_roofline",
        "tiny_fold_ms_per_pass")] == [None] * 3
