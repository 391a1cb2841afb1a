"""The benchmark configuration ``big_instanced`` (an instancing deployment:
one OBJ placed five times by per-shape transforms, at the offsets and
materials of ``models/demo.py`` ``big_streamed_scene``, which instead bakes
them into one merged domain: ``portbench/configs/big_instanced.json``) and
what its cell reads of the domain loop, on the CPU:

  * each of the five copies, the OBJ's float32 vertices plus the copy's
    one-key translation, lands on ``big_streamed_scene``'s copy bit for
    bit; the materials, the plane, the light and the camera are the
    demo's and the bench's;
  * compiled at the published n = 64, the scene has five traversal
    domains (the world-space one holding the centre copy, four under a
    transform), 1,920 clusters and 245,760 triangles, and it moves;
  * ``portbench/run.py`` ``main`` runs the configuration on the n = 8
    stand-in at a tiny traffic on a copy of the checkout and is
    ``correct`` against the plain reference; the reference in bfloat16 is
    not;
  * with tracing on, ``traverse.lanes`` is the lanes of every
    ``traverse()`` call of a pass and ``traverse.live_rays`` at most that;
    ``traverse.chain_lanes`` the lanes of the four transformed copies'
    calls; nothing is counted with tracing off;
  * every ``traverse()`` call of a traced pass lies inside a ``domain``
    span and every winner re-test inside a ``domain_merge`` span inside
    it, on the closest-hit and the any-hit path;
  * the three new readers on a synthetic span render, and None before
    their spans or counters exist.
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

from portbench import port_scene, run, spec, standin  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from rayito_tpu_torch.models import demo as tdemo  # noqa: E402
from rayito_tpu_torch.utils import tracing  # noqa: E402

CONFIG = os.path.join(ROOT, "portbench", "configs", "big_instanced.json")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.enable(False)
    tracing.reset()


def _config():
    with open(CONFIG) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def obj8(tmp_path_factory):
    """The benchmark's stand-in at n = 8: 768 triangles a copy, still above
    the 192 of a tiny mesh, so each transformed copy is a domain."""
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    standin.write_bumpy_standin(path, n=8)
    return path


def _same_bits(a, b, dtype=np.float32):
    a, b = np.asarray(a, dtype), np.asarray(b, dtype)
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def test_the_configuration_is_big_streamed_scene_as_instances(obj8):
    import inspect

    from rayito_tpu.models import camera as jcamera
    from rayito_tpu.models import demo as jdemo

    cfg = _config()
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    got = port_scene.build(cfg, {"bumpy": obj8})
    want = jdemo.big_streamed_scene(obj8)
    assert len(got.meshes) == len(want.meshes) == 5
    for g, w in zip(got.meshes, want.meshes):
        t = g.transform
        assert t.num_keys == 1 and list(t.times) == [0.0]
        assert [tuple(v) for v in t.scales] == [(1.0, 1.0, 1.0)]
        assert [tuple(v) for v in t.rotations] == [(1.0, 0.0, 0.0, 0.0)]
        placed = (np.asarray(g.vertices, np.float32)
                  + np.asarray(t.translations[0], np.float32))
        assert _same_bits(placed, w.vertices)
        assert np.array_equal(g.indices, w.indices)
        assert _same_bits(g.normals, w.normals)
        assert np.array_equal(g.normal_indices, w.normal_indices)
        assert (g.material.kind, tuple(g.material.color),
                g.material.param) == (w.material.kind,
                                      tuple(w.material.color),
                                      w.material.param)
    assert sum(m.transform.is_identity() for m in got.meshes) == 1
    (gp,), (wp,) = got.planes, want.planes
    for k in ("position", "normal"):
        assert _same_bits(getattr(gp, k), getattr(wp, k)), k
    assert gp.bullseye == wp.bullseye is False
    assert (gp.material.kind, tuple(gp.material.color)) == (
        wp.material.kind, tuple(wp.material.color))
    (gl,), (wl,) = got.rect_lights, want.rect_lights
    for k in ("corner", "side1", "side2", "color"):
        assert _same_bits(getattr(gl, k), getattr(wl, k)), k
    assert gl.power == wl.power == 3.0
    # bench.py's big_245k_streamed_path_trace: make(40.0, *STAGE6_CAMERA)
    # with make's defaults
    cam = cfg["camera"]
    assert cam["fov_degrees"] == 40.0
    assert (tuple(cam["origin"]), tuple(cam["target"]),
            tuple(cam["up"])) == jdemo.STAGE6_CAMERA
    defaults = inspect.signature(jcamera.PerspectiveCamera.make).parameters
    assert (cam["focal_distance"], cam["lens_radius"], *cam["shutter"]) == (
        defaults["focal_distance"].default, defaults["lens_radius"].default,
        defaults["shutter_open"].default, defaults["shutter_close"].default)
    ours = run.camera_of(cam)
    theirs = type(ours).make(40.0, *tdemo.STAGE6_CAMERA)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        a, b = (torch.stack([x.x, x.y, x.z]) if hasattr(x, "z") else x
                for x in (a, b))
        assert torch.equal(a, b), f.name


@pytest.fixture(scope="module")
def big64(tmp_path_factory):
    """The configuration as the cell compiles it: the n = 64 stand-in."""
    cfg = _config()
    cache = str(tmp_path_factory.mktemp("standin"))
    path = standin.cached(cache, cfg["meshes"]["bumpy"])
    return port_scene.build(cfg, {"bumpy": path}).compile(CPU)


def test_the_cell_scene_has_five_domains_and_1920_clusters(big64):
    s = big64
    assert s.ktab_xf == (0, 1, 2, 3, 4) and s.ktab_small == ()
    assert s.has_motion and s.n_meshes == 5
    assert [t.shape for t in s.ktab_tri] == [(384, 16, 128)] * 5
    assert sum(t.shape[0] for t in s.ktab_tri) == 1920
    assert tuple(s.tri_vm_rows.shape) == (245760, 32)
    assert [n for _, n in s.mesh_tri_ranges] == [49152] * 5


def _copy_checkout(root, n: int):
    """A copy of the benchmark with the configuration's stand-in at ``n``
    and a tiny traffic of two bands a pass."""
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    cfg_path = root / "portbench" / "configs" / "big_instanced.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["meshes"]["bumpy"]["n"] = n
    cfg_path.write_text(json.dumps(cfg))
    tiny = {"why": "a test frame", "loop": "closed", "users": 1,
            "width": 24, "height": 16, "pixel_samples": 2,
            "light_samples": 1, "max_depth": 3, "max_rays_per_pass": 192}
    (root / "portbench" / "traffic" / "tiny_test.json").write_text(
        json.dumps(tiny))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "big_instanced.tiny_test",
                               "config": "big_instanced",
                               "traffic": "tiny_test", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_the_run_on_the_cpu_is_correct(tmp_path):
    root = tmp_path / "checkout"
    _copy_checkout(root, 8)
    # a process of its own (the program from this checkout, the benchmark
    # from the copy): the run refuses to report where a module of JAX is
    # loaded, as it is in this one
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; "
            "sys.exit(run.main(sys.argv[3:], device='cpu', root=sys.argv[1], "
            "here=sys.argv[2]))")
    out = subprocess.run(
        [sys.executable, "-c", code, str(root), str(root / "portbench"),
         "--workload", "big_instanced.tiny_test", "--seed",
         str(2**31 + 23), "--seconds", "0.05", "--trace", "0"],
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

    cfg = _config()
    flat = rscene.flatten(cfg, {"bumpy": obj8})
    assert flat.moving and len(flat.meshes) == 5
    rc = dict(width=32, height=16, pixel_samples=2, light_samples=1,
              max_depth=3, seed=2**31 + 29)
    pix = np.arange(32 * 16)
    ref = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu")
    low = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu",
                               torch.bfloat16)
    assert compare.mismatch_share(low, ref) > 3 * compare.MISMATCH_LIMIT


# ------------------------------------------------ the domain loop, traced


@pytest.fixture(scope="module")
def big8(obj8):
    return port_scene.build(_config(), {"bumpy": obj8}).compile(CPU)


def _pass(scene, traced: bool):
    """One eager path pass of a 24x16 frame, one sample, depth 2."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=24, height=16, pixel_samples=1, light_samples=1,
                       max_depth=2, max_rays_per_pass=24 * 16, seed=7)
    cam = run.camera_of(_config()["camera"])
    si = torch.zeros(1, dtype=torch.int32)
    row0 = torch.zeros((), dtype=torch.int32)
    with tracing.on(traced):
        tracing.reset()
        pt._path_pass_body(scene, cfg, cam, si, row0, 16)
        snap = tracing.snapshot()
        tracing.reset()
    return snap


def _spied(monkeypatch):
    """Record each traverse() call's lanes and the names of the spans open
    at it, and the spans open at each winner re-test."""
    from rayito_tpu_torch.render import trace as ttrace

    calls, retests = [], []
    real_traverse, real_retest = ttrace.traverse, ttrace._winner_retest

    def stack():
        return [s.name for s in tracing._stack]

    def traverse(o, *a, **kw):
        calls.append((o.x.shape[0], stack()))
        return real_traverse(o, *a, **kw)

    def retest(*a, **kw):
        retests.append(stack())
        return real_retest(*a, **kw)

    monkeypatch.setattr(ttrace, "traverse", traverse)
    monkeypatch.setattr(ttrace, "_winner_retest", retest)
    return calls, retests


def test_traverse_lanes_counts_every_call_of_a_pass(big8, monkeypatch):
    calls, _ = _spied(monkeypatch)
    snap = _pass(big8, traced=True)
    c = snap.counters
    # depth 2: a closest-hit and two any-hit queries a bounce, five
    # domains each
    assert len(calls) == 2 * 3 * 5
    assert c["traverse.lanes"] == sum(n for n, _ in calls) == 30 * 384
    assert 0 < c["traverse.live_rays"] <= c["traverse.lanes"]
    calls.clear()
    snap = _pass(big8, traced=False)
    assert len(calls) == 30 and snap.counters == {}
    assert snap.device == [] and snap.host == []


def test_chain_lanes_count_the_four_transformed_domains(big8):
    """``traverse.chain_lanes``: the lanes ``ray_pack`` took through a
    domain's chain, those of the four copies under a translation, none of
    the centre copy's; no ``transforms`` span opens inside a domain."""
    from rayito_tpu_torch.ops import transform as xf

    chained = [bool(xf.chain_slots(big8, x)) for x in big8.ktab_xf]
    assert chained.count(True) == 4 and chained.count(False) == 1
    snap = _pass(big8, traced=True)
    c = snap.counters
    assert c["traverse.chain_lanes"] == 6 * 4 * 384
    assert c["traverse.chain_lanes"] * 5 == c["traverse.lanes"] * 4
    by_id = {s.id: s for s in snap.device}
    for s in snap.device:
        if s.name == "transforms":
            while s.parent in by_id:
                s = by_id[s.parent]
                assert s.name != "domain"


@pytest.mark.parametrize("mt", ["bw_closest", "bw"])
def test_every_traverse_and_retest_lies_in_a_domain_span(big8, mt,
                                                         monkeypatch):
    """'bw_closest' (the default) re-tests closest-hit winners only; 'bw'
    re-tests any-hit winners too."""
    calls, retests = _spied(monkeypatch)
    snap = _pass(dataclasses.replace(big8, traverse_mt=mt), traced=True)

    def kind(names):
        return ("closest" if "query.closest" in names else
                "any" if any(n.startswith("query.shadow") for n in names)
                else None)

    assert {kind(names) for _, names in calls} == {"closest", "any"}
    assert all(names[-2:] == ["mesh", "domain"] for _, names in calls)
    assert {kind(names) for names in retests} == (
        {"closest", "any"} if mt == "bw" else {"closest"})
    assert all(names[-3:] == ["mesh", "domain", "domain_merge"]
               for names in retests)
    names = [s.name for s in snap.device]
    # one domain span and one merge span a traverse() call
    assert names.count("domain") == names.count("domain_merge") == len(calls)
    by_id = {s.id: s for s in snap.device}
    for s in snap.device:
        if s.name == "domain_merge":
            assert by_id[s.parent].name == "domain"
        if s.name == "domain":
            assert by_id[s.parent].name == "mesh"


# ------------------------------------------------ readers


def _span(i, name, start, end):
    return types.SimpleNamespace(id=i, name=name, kind="device", start=start,
                                 end=end)


def _ctx(spans, counters):
    """A span render of one render of four passes: kernels inside two
    domain spans (one of them in the plumbing), inside their merges,
    in the mesh span outside any domain, and outside every span."""
    kernels = [("ray_pack_kernel", 125.0, 10.0),
               ("blocks_fold_kernel", 200.0, 20.0),
               ("gather_rows_t_kernel", 260.0, 5.0),
               ("blocks_fold_kernel", 320.0, 30.0),
               ("elementwise", 460.0, 4.0),
               ("fold_small_kernel", 550.0, 7.0),
               ("bounce_prepare_kernel", 700.0, 9.0)]
    trace = Trace(lo=0.0, hi=1000.0, kernels=kernels, copies=[],
                  runtime=[], host=[], passes=4)
    return types.SimpleNamespace(trace=trace, span_trace=trace, spans=spans,
                                 counters=counters)


SPANS = [_span(1, "mesh", 100.0, 600.0),
         _span(2, "domain", 110.0, 300.0),
         _span(3, "traversal_plumbing", 120.0, 150.0),
         _span(4, "domain_merge", 250.0, 290.0),
         _span(5, "domain", 310.0, 500.0),
         _span(6, "domain_merge", 450.0, 490.0)]


def test_readers_on_a_synthetic_span_render():
    ctx = _ctx(SPANS, {"traverse.lanes": 1000, "traverse.live_rays": 250,
                       "traverse.pairs": 9})
    read = lambda name: spec.metric_reader(name)(ctx)  # noqa: E731
    # (10 + 20 + 5 + 30 + 4) us over four passes; the merges (5 + 4) us
    assert read("domain_ms_per_pass") == pytest.approx(0.01725)
    assert read("domain_merge_ms_per_pass") == pytest.approx(0.00225)
    assert read("domain_live_share") == pytest.approx(25.0)


def test_readers_find_nothing_before_their_spans_and_counters():
    """The parent's program: a mesh span with the plumbing in it, but no
    domain spans and no lane counter."""
    old = [_span(1, "mesh", 100.0, 600.0),
           _span(3, "traversal_plumbing", 120.0, 150.0)]
    ctx = _ctx(old, {"traverse.live_rays": 250, "traverse.pairs": 9})
    names = ("domain_ms_per_pass", "domain_merge_ms_per_pass",
             "domain_live_share")
    assert [spec.metric_reader(m)(ctx) for m in names] == [None] * 3
    ctx = types.SimpleNamespace(trace=Trace(lo=0.0, hi=1.0, kernels=[],
                                            copies=[], runtime=[], host=[],
                                            passes=1))
    assert [spec.metric_reader(m)(ctx) for m in names] == [None] * 3
