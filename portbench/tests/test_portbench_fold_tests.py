"""The reader of ``fold_tests_per_ray`` on synthetic counters: the slices
the fold ran, 32 x 32 tests each, over the live rays; None where the
program counts no slices (a tree before the fold's slice cull) or no
live rays, and where the program has no tracing module."""

import sys
import types

import pytest

from portbench import spec
from portbench.trace import Trace


def _ctx(counters):
    tr = Trace(lo=0.0, hi=1.0, kernels=[("fold", 0.0, 1.0)], copies=[],
               runtime=[], host=[], passes=1)
    return types.SimpleNamespace(trace=tr, span_trace=tr, spans=[],
                                 counters=counters)


def _read(ctx):
    return spec.metric_reader("fold_tests_per_ray")(ctx)


def test_tests_run_per_live_ray():
    ctx = _ctx({"traverse.slices": 10, "traverse.pairs": 4,
                "traverse.live_rays": 1280})
    assert _read(ctx) == pytest.approx(8.0)
    # the mask's pairs, read by tri_tests_per_ray, do not enter
    assert spec.metric_reader("tri_tests_per_ray")(ctx) == pytest.approx(
        51.2)


@pytest.mark.parametrize("counters", [
    {"traverse.pairs": 4, "traverse.live_rays": 1280},
    {"traverse.slices": 10},
    {"traverse.slices": 10, "traverse.live_rays": 0},
    {},
])
def test_none_without_the_counters(counters):
    assert _read(_ctx(counters)) is None


def test_none_without_a_tracing_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "rayito_tpu_torch.utils.tracing", None)
    ctx = types.SimpleNamespace(trace=_ctx({}).trace)
    assert _read(ctx) is None
