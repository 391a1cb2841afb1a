"""The readers of the program's spans and counters (``spans.py`` and the
metrics that read it) on a synthetic span render: each layer's device ms
by the innermost spans around its operations, the host stall inside the
read-back and add spans, the triangle tests per ray; and the parent's
path, where the program has no tracing module and every new metric
returns None without raising."""

import sys
import types

import pytest

from portbench import spans, spec
from portbench.trace import Trace

NEW = ("folds_self_ms_per_pass", "transforms_ms_per_pass",
       "plumbing_ms_per_pass", "host_stall_ms_per_pass", "tri_tests_per_ray")
MARK = "void (anonymous namespace)::trace_mark_kernel(long long*, int*)"


def _span(i, name, start, end, kind="device"):
    return types.SimpleNamespace(id=i, name=name, kind=kind, start=start,
                                 end=end)


def _ctx():
    """Two passes: a bounce whose closest-hit query holds the analytic
    folds (a transform inside them) and the mesh (plumbing and the tiny
    fold inside it); a host add while the device idles."""
    device = [_span(1, "bounce[0]", 0.0, 500.0),
              _span(2, "query.closest", 10.0, 400.0),
              _span(3, "analytic_folds", 20.0, 200.0),
              _span(4, "transforms", 50.0, 100.0),
              _span(5, "mesh", 200.0, 390.0),
              _span(6, "traversal_plumbing", 210.0, 250.0),
              _span(7, "tiny_mesh_fold", 300.0, 380.0)]
    host = [_span(8, "band.replay", -5.0, 3.0, "host"),
            _span(9, "band.host_add", 500.0, 650.0, "host")]
    kernels = [(MARK, 0.0, 1.0), ("transform_add", 60.0, 10.0),
               ("fold_where", 150.0, 20.0), ("sort", 220.0, 5.0),
               ("fold_small_kernel", 310.0, 30.0), ("shade", 450.0, 40.0),
               (MARK, 499.0, 1.0), ("stray", 600.0, 10.0)]
    tr = Trace(lo=0.0, hi=1000.0, kernels=kernels, copies=[], runtime=[],
               host=[], passes=2)
    return types.SimpleNamespace(trace=tr, span_trace=tr,
                                 spans=device + host,
                                 counters={"traverse.pairs": 10,
                                           "traverse.live_rays": 1280})


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_layers_read_the_innermost_spans():
    ctx = _ctx()
    # the analytic fold's own 20 us and the tiny fold's 30, per pass
    assert _read("folds_self_ms_per_pass", ctx) == pytest.approx(0.025)
    assert _read("transforms_ms_per_pass", ctx) == pytest.approx(0.005)
    assert _read("plumbing_ms_per_pass", ctx) == pytest.approx(0.0025)
    # every operation but the stray one lies inside a span; markers left out
    assert spans.coverage(ctx) == pytest.approx(105.0 / 115.0)
    q = ("bounce[0]", "query.closest")
    assert spans.attributed(ctx) == [
        (q + ("analytic_folds", "transforms"), 10.0),
        (q + ("analytic_folds",), 20.0),
        (q + ("mesh", "traversal_plumbing"), 5.0),
        (q + ("mesh", "tiny_mesh_fold"), 30.0),
        (("bounce[0]",), 40.0), ((), 10.0)]


def test_host_stall_is_idle_device_time_inside_the_host_spans():
    # idle inside the add: [500, 600) and [610, 650); the replay's span
    # is not a stall span
    assert _read("host_stall_ms_per_pass", _ctx()) == pytest.approx(0.07)


def test_triangle_tests_per_live_ray():
    assert _read("tri_tests_per_ray", _ctx()) == pytest.approx(128.0)
    ctx = _ctx()
    ctx.counters = {"traverse.pairs": 3}
    assert _read("tri_tests_per_ray", ctx) is None


def test_the_parent_has_no_spans_and_every_new_metric_is_none(monkeypatch):
    """A tree before the tracing module: ctx.spans is absent, the import
    fails, and each new reader returns None (no span render runs)."""
    monkeypatch.setitem(sys.modules, "rayito_tpu_torch.utils.tracing", None)
    ctx = types.SimpleNamespace(trace=_ctx().trace)
    assert not hasattr(ctx, "spans")
    assert [_read(name, ctx) for name in NEW] == [None] * len(NEW)
    assert ctx.spans is None and ctx.counters is None


def test_no_card_no_span_render():
    ctx = types.SimpleNamespace(trace=Trace(lo=0.0, hi=1.0, kernels=[],
                                            copies=[], runtime=[], host=[],
                                            passes=1))
    assert [_read(name, ctx) for name in NEW] == [None] * len(NEW)
