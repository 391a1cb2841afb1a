"""The benchmark's arithmetic on synthetic inputs: the tail over passes,
the rate over the whole window, the idle share from overlapping device
intervals, the shading kernels' bytes, the traced-stretch readers."""

import statistics
import types

import numpy as np
import pytest

from portbench import compare, stats, trace
from portbench.rooflines import shade


def test_p95_is_numpys_linear_percentile():
    rng = np.random.default_rng(5)
    for n in (1, 2, 19, 20, 21, 250):
        v = list(rng.exponential(40.0, n))
        assert stats.percentile(v, 95) == pytest.approx(
            float(np.percentile(v, 95)), rel=1e-12)
    # 100 passes of 10 ms and five stalls of 50 ms: the stalls are the top
    # 5%, so the 95th percentile sits between them and the rest
    v = [10.0] * 95 + [50.0] * 5
    assert 10.0 < stats.percentile(v, 95) < 50.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(1_228_800, 0.4) == pytest.approx(3_072_000.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    v = [10.0, 10.2, 10.1, 9.9, 10.4, 10.0]
    q1, m, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / m)


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert stats.union_length(iv, 0, 60) == 15 + 10 + 10
    assert stats.union_length(iv, 8, 45) == 7 + 10 + 5
    assert stats.gaps(iv, 0, 60) == [(15, 20), (30, 40), (50, 60)]
    assert stats.gaps([], 0, 5) == [(0, 5)]


def test_idle_share_and_breakdown_from_a_stretch():
    tr = trace.Trace(
        lo=0.0, hi=100.0,
        kernels=[("void a_kernel<1>(int)", 0.0, 30.0),
                 ("(anonymous namespace)::b_kernel(float*)", 20.0, 20.0),
                 ("void a_kernel<1>(int)", 60.0, 10.0)],
        copies=[("Memcpy DtoH (Device -> Pageable)", 75.0, 5.0)],
        runtime=[("cudaGraphLaunch", 0.0, 1.0),
                 ("cudaLaunchKernel", 59.0, 1.0),
                 ("cudaMemcpyAsync", 74.0, 1.0)],
        host=[("aten::copy_", 85.0, 10.0), ("aten::to", 82.0, 16.0)],
        passes=2)
    assert tr.busy_us == 40.0 + 10.0 + 5.0
    ctx = types.SimpleNamespace(trace=tr, launch_calls=trace.LAUNCHES,
                                kernel_id=trace.kernel_id,
                                hand_kernels={"b_kernel"})
    from portbench.metrics import (device_idle_pct, device_ops_per_pass,
                                   host_launches_per_pass,
                                   torch_kernel_ms_per_pass)
    assert device_idle_pct.read(ctx) == pytest.approx(45.0)
    assert device_ops_per_pass.read(ctx) == 2.0
    assert host_launches_per_pass.read(ctx) == 1.0
    assert torch_kernel_ms_per_pass.read(ctx) == pytest.approx(0.02)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["a_kernel<1>(int)", pytest.approx(40e-6)]
    # device busy [0, 40), [60, 70), [75, 80): gaps of 20, 5 and 20 us,
    # the last while the host copied
    assert [[n, round(s * 1e6, 6)] for n, s in b["idle_gaps"]] == [
        ["host: no torch op", 20.0], ["host: aten::copy_", 20.0],
        ["host: no torch op", 5.0]]


def test_kernel_ids_and_the_hand_kernels_of_the_sources(tmp_path):
    assert trace.kernel_id(
        "(anonymous namespace)::cluster_masks_kernel(float const*, int)"
    ) == "cluster_masks_kernel"
    assert trace.kernel_id(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<int>, std::array<char*, 1ul> >(int, ...)"
    ) == "vectorized_elementwise_kernel"
    (tmp_path / "k.cu").write_text(
        "__global__ void __launch_bounds__(128)\nfoo_kernel(int n) {}\n"
        "template <int N> __global__ void bar_kernel(float* x) {}\n"
        "__device__ void not_a_kernel(int) {}\n")
    assert trace.hand_kernels(str(tmp_path)) == {"foo_kernel", "bar_kernel"}


def test_shade_bytes_at_one_light_sample():
    # 245 and 222 bytes a lane, static analytic lights (PERF.md, PR 15)
    assert shade.lane_bytes("bounce_prepare_kernel", 1, False, True) == 245
    assert shade.lane_bytes("bounce_resolve_kernel", 1, False, True) == 222
    # each further light sample: 6 draw rows read, 74 and 66 + 2 bytes
    assert shade.lane_bytes("bounce_prepare_kernel", 4, False, True) == (
        245 + 3 * (24 + 74))
    assert shade.lane_bytes("bounce_resolve_kernel", 4, True, True) == (
        222 + 4 + 3 * 68)
    s = shade.least_seconds({"bounce_prepare_kernel": 2,
                             "bounce_resolve_kernel": 1}, 1000, 1, False,
                            True, 100)
    assert s == pytest.approx((2 * 245_100 + 222_100) / 3.35e12)


def test_pixel_samples_are_drawn_from_the_seed():
    a = compare.sample_pixels(2**31 + 5, 640, 480)
    assert len(a) == compare.PIXELS == len(set(a.tolist()))
    assert np.array_equal(a, compare.sample_pixels(2**31 + 5, 640, 480))
    assert not np.array_equal(a, compare.sample_pixels(2**31 + 6, 640, 480))
    assert a.min() >= 0 and a.max() < 640 * 480
    assert np.array_equal(compare.sample_pixels(1, 16, 8), np.arange(128))


def test_mismatch_rule():
    ref = np.array([[1.0, 0.5, 0.0], [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]])
    got = ref + np.array([[5e-4, 0, 0], [2e-5, 0, 0], [0, 0, 3e-3]])
    assert compare.mismatch(got, ref).tolist() == [False, True, True]
    got[0, 0] = np.nan
    assert compare.mismatch(got, ref)[0]
