"""The port's tracing (``rayito_tpu_torch/utils/tracing.py``) on the CPU.

  * off (the default) records no span and no counter, and leaves the pass
    graphs' key as it was; on, the key differs, and off again restores it;
  * the spans of an eager CPU render nest as the tree the benchmark reads:
    render > pass > band.replay > camera_rays, bounce[i] (query.closest
    > analytic_folds, mesh > domain > traversal_plumbing, domain_merge;
    draws; shading.prepare; query.shadow[0]; shading.resolve), image;
    band.readback (> readback,
    the copy) and band.host_add beside the replays; each with its parent,
    and one request id (render, first sample, band) per band;
  * ``traverse.pairs`` and ``traverse.live_rays`` on a small stage-6
    frame equal a popcount of the plain ``cluster_masks_plain`` output and
    the live lanes of the coherence keys; the query counters add up to
    the render's issued queries;
  * a captured graph's Python-number counts are booked once per replay;
  * the marker-to-trace pairing on a synthetic Chrome trace, and a
    marker or host range too few, which must raise;
  * ``launch_counts`` raises while tracing is off;
  * ``collect_device_ops`` drops a span's device-side annotation row;
  * ``span_table``'s self time is a span less its child spans.

The same on the card (markers in the replayed graphs, their durations
from the log against the profiler's) is in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.render import progressive as tprog
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils import cuda_lib, graphs, tracing
from rayito_tpu_torch.utils.config import RenderConfig as TConfig

MISS = 1 << 30


@pytest.fixture(scope="module")
def stage6(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bumpy") / "bumpy.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return (tdemo.stage6_scene(path).compile("cpu"),
            TCam.make(30.0, *tdemo.STAGE6_CAMERA))


@pytest.fixture(autouse=True)
def _fresh():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def _render(stage6, **kw):
    scene, cam = stage6
    cfg = TConfig(width=16, height=12, pixel_samples=1, light_samples=1,
                  max_depth=3, max_rays_per_pass=96, seed=5, **kw)
    return tprog.render_progressive(scene, cfg, cam,
                                    on_progress=lambda st: None)


def test_off_records_nothing_and_keeps_the_graph_key(stage6):
    assert not tracing.enabled()
    _, st = _render(stage6)
    snap = tracing.snapshot()
    assert snap.host == [] and snap.device == [] and snap.counters == {}
    scene = stage6[0]
    off = graphs.full_key(("path", 1), scene, "cpu")
    with tracing.on():
        on = graphs.full_key(("path", 1), scene, "cpu")
    assert on != off and on[:3] == off[:3]
    assert graphs.full_key(("path", 1), scene, "cpu") == off
    assert st.rays_traced > 0


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def test_spans_of_an_eager_cpu_render_nest_as_the_tree(stage6):
    with tracing.on():
        _render(stage6)
    snap = tracing.snapshot()
    host = {s.id: s for s in snap.host}
    names = [s.name for s in snap.host]
    assert names.count("render") == 1 and names.count("pass") == 1
    assert names.count("progress") == 1
    # 12 rows at 96 lanes a launch: two bands of 6 rows
    for name in ("band.replay", "band.readback", "band.host_add"):
        assert names.count(name) == 2, name
    render = next(s for s in snap.host if s.name == "render")
    pas = next(s for s in snap.host if s.name == "pass")
    assert render.parent is None and pas.parent == render.id
    replays = [s for s in snap.host if s.name == "band.replay"]
    assert [r.request for r in replays] == [(render.id, 0, 0),
                                            (render.id, 0, 1)]
    for s in snap.host:
        if s.name.startswith("band."):
            assert s.parent == pas.id and s.request in (
                (render.id, 0, 0), (render.id, 0, 1))
    dev = snap.device
    by_id = {s.id: s for s in dev}
    for rep in replays:
        assert _children(dev, rep.id) == [
            "camera_rays", "bounce[0]", "bounce[1]", "bounce[2]", "image"]
        band = [s for s in dev if _root(s, by_id) == rep.id]
        assert {s.request for s in band} == {rep.request}
        for s in band:
            outer = by_id.get(s.parent) or host[s.parent]
            assert outer.start <= s.start <= s.end <= outer.end
        for b in (s for s in band if s.name.startswith("bounce[")):
            assert _children(dev, b.id) == [
                "query.closest", "draws", "shading.prepare",
                "query.shadow[0]", "shading.resolve"]
        for q in (s for s in band if s.name == "query.closest"):
            assert _children(dev, q.id) == ["analytic_folds", "mesh"]
        for q in (s for s in band if s.name == "query.shadow[0]"):
            # the light- and BRDF-sampled any-hit queries
            assert _children(dev, q.id) == ["analytic_folds", "mesh"] * 2
        for m in (s for s in band if s.name == "mesh"):
            # stage 6's one traversal domain
            assert _children(dev, m.id) == ["domain"]
        for d in (s for s in band if s.name == "domain"):
            assert _children(dev, d.id) == ["traversal_plumbing"] * 2 + [
                "domain_merge"]
    for rb in (s for s in snap.host if s.name == "band.readback"):
        assert _children(dev, rb.id) == ["readback"]
        assert {s.request for s in dev if s.parent == rb.id} == {rb.request}
    assert all(s.kind == "device" and s.device == "cpu" for s in dev)
    assert len({s.id for s in snap.host + dev}) == len(snap.host + dev)


def _root(span, by_id):
    while span.parent in by_id:
        span = by_id[span.parent]
    return span.parent


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.astype("<i4").view(np.uint8)).sum())


def test_traversal_counters_equal_the_plain_masks(stage6, monkeypatch):
    masks, keys = [], []
    plain, key = tv.cluster_masks_plain, tv.coherence_key

    def spy_masks(*a, **kw):
        out = plain(*a, **kw)
        masks.append(out.numpy().copy())
        return out

    def spy_key(*a, **kw):
        out = key(*a, **kw)
        keys.append(out.numpy().copy())
        return out

    monkeypatch.setattr(tv, "cluster_masks_plain", spy_masks)
    monkeypatch.setattr(tv, "coherence_key", spy_key)
    with tracing.on():
        _, st = _render(stage6)
        c = tracing.counters()
    # three bounces of a closest-hit and two any-hit queries, two bands
    assert len(masks) == len(keys) == 18
    assert c["traverse.pairs"] == sum(_popcount(m) for m in masks) > 0
    assert c["traverse.live_rays"] == sum(int((k < MISS).sum())
                                          for k in keys) > 0
    assert (c["query.rays.closest"] + c["query.rays.shadow"]
            == st.rays_traced)
    assert not any(k.startswith("launches.") for k in c)  # plain on a CPU
    assert tv.popcount(torch.tensor([-1, 0, 5, -2**31],
                                    dtype=torch.int32)) == 32 + 2 + 1


def test_a_captured_graphs_counts_are_booked_per_replay():
    tpl = tracing.Template(torch.device("cuda", 0))
    tpl.counts = {"launches.cmj": 3, "launches.shade": 2}
    with tracing.on():
        tracing.replayed(tpl)
        tracing.replayed(tpl)
        tracing.count("launches.cmj", 1)
        assert tracing.counters() == {"launches.cmj": 7,
                                      "launches.shade": 4}
        tracing.reset_counts("launches.cm")
        assert tracing.counters() == {"launches.shade": 4}


def _synthetic():
    """A snapshot of two device spans (an outer and an inner one) on
    cuda:0 and one host span, and the Chrome-trace events of a profile
    of the same work."""
    S = tracing.Span
    snap = tracing.Snapshot(
        host=[S(0, "band.replay", "host", "host", 10, 90, None, (0, 0, 0))],
        device=[S(1, "bounce[0]", "device", "cuda:0", 1000, 1400, 0,
                  (0, 0, 0), (0, 3)),
                S(2, "mesh", "device", "cuda:0", 1100, 1300, 1, (0, 0, 0),
                  (1, 2))],
        counters={}, marks={"cuda:0": 4})
    mark = lambda ts: {"ph": "X", "cat": "kernel", "ts": ts, "dur": 2.0,
                       "name": "(anonymous namespace)::trace_mark_kernel("
                               "long long*, int*, int, int)",
                       "args": {"device": 0}}
    events = [mark(t) for t in (130.0, 100.0, 110.0, 120.0)] + [
        {"ph": "X", "cat": "kernel", "ts": 104.0, "dur": 3.0,
         "name": "blocks_fold_kernel", "args": {"device": 0}},
        {"ph": "X", "cat": "user_annotation", "ts": 95.0, "dur": 40.0,
         "name": "band.replay"},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 99.0, "dur": 33.0,
         "name": "band.replay"},
        {"ph": "X", "cat": "user_annotation", "ts": 90.0, "dur": 50.0,
         "name": "portbench.stretch"}]
    return snap, events


def test_markers_pair_with_the_log_in_order():
    snap, events = _synthetic()
    spans = {s.id: s for s in tracing.on_trace(snap, events)}
    assert (spans[0].start, spans[0].end) == (95.0, 135.0)
    # the begin marker's end to the end marker's start, in trace order
    assert (spans[1].start, spans[1].end) == (102.0, 130.0)
    assert (spans[2].start, spans[2].end) == (112.0, 120.0)
    assert spans[2].parent == 1 and spans[1].parent == 0
    assert spans[1].request == (0, 0, 0)


@pytest.mark.parametrize("drop", ["marker", "host range"])
def test_a_count_mismatch_in_the_trace_raises(drop):
    snap, events = _synthetic()
    cat = "kernel" if drop == "marker" else "user_annotation"
    k = next(i for i, e in enumerate(events) if e["cat"] == cat)
    del events[k]
    with pytest.raises(ValueError, match="the trace holds"):
        tracing.on_trace(snap, events)


def test_launch_counts_need_tracing_on():
    with pytest.raises(RuntimeError, match="tracing is off"):
        cuda_lib.launch_counts()
    with tracing.on():
        cuda_lib.reset_launch_counts()
        assert set(cuda_lib.launch_counts().values()) == {0}
    assert not tracing.enabled()


def test_collect_device_ops_drops_span_annotations():
    """A host span's range leaves a device-side annotation row that spans
    its kernels and their gaps: it is no kernel."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from rayito_tpu_torch.utils.profiling import collect_device_ops

    def row(key, us, count, annotation=False):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=DeviceType.CUDA,
                               is_user_annotation=annotation)

    rows = [row("band.replay", 9000.0, 2, annotation=True),
            row("trace_mark_kernel(long long*, int*, int, int)", 40.0, 20),
            row("void at::native::vectorized_elementwise_kernel<4>", 1000.0,
                50)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert list(collect_device_ops(prof)) == [rows[1].key, rows[2].key]


def test_span_table_self_time_is_the_span_less_its_children():
    from rayito_tpu_torch.utils.profiling import span_table

    S = tracing.Span
    snap = tracing.Snapshot(host=[], counters={}, marks={}, device=[
        S(1, "mesh", "device", "cuda:0", 0, 5e6, None, None, (0, 5)),
        S(2, "traversal_plumbing", "device", "cuda:0", 1e6, 2e6, 1, None,
          (1, 2)),
        S(3, "traversal_plumbing", "device", "cuda:0", 3e6, 4.5e6, 1, None,
          (3, 4)),
        S(4, "mesh", "device", "cuda:0", 6e6, 7e6, None, None, (6, 7))])
    assert span_table(snap, divisor=2.0) == {
        "mesh": (3.0, 1.75, 2), "traversal_plumbing": (1.25, 1.25, 2)}
