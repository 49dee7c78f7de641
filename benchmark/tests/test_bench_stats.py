import pytest

from benchmark import stats


def test_run_s_is_window_over_runs():
    assert stats.run_s(30.0, 12) == 2.5
    with pytest.raises(ValueError):
        stats.run_s(30.0, 0)


def test_percentile_linear_between_ranks():
    v = [float(x) for x in range(1, 101)]
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 50) == 2.5


def test_interval_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 45)]
    assert stats.interval_union(iv) == [(0, 15), (20, 31), (40, 45)]
    assert stats.busy_ns(iv) == 15 + 11 + 5
    assert stats.busy_ns(iv, 8, 42) == 7 + 11 + 2
    assert stats.idle_gaps(iv, 0, 50) == [(15, 20), (31, 40), (45, 50)]


def test_ks_gram_roofline_count_at_the_k1_shape():
    flops, nbytes = stats.ks_gram_count(2000, 100, 100)
    assert nbytes == 2000 * 100 * 100 * 8 + 14 * 8  # the float64 field once, 14 statistics
    assert flops == 1999 * 100 * 100 * 49
    t, what = stats.roofline_s(flops, nbytes)
    assert what == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12)
    assert t * 1e3 == pytest.approx(0.0478, abs=1e-4)


def test_the_wall_reader_is_the_traced_window_over_its_runs():
    from benchmark import harness

    read = harness.load_metric("wall.s_per_run").read
    assert read(harness.TraceData({}, None, {}, {}, window_s=3.0, n_runs=4)) == 0.75
    assert read(harness.TraceData({}, None, {}, {}, window_s=3.0, n_runs=0)) is None


def test_the_ks_idle_share_reads_as_the_shared_one():
    from benchmark import harness
    from benchmark.tracing import DeviceTrace

    # 1.5 s of device work in a 2 s window: 25% idle, under either name
    tr = DeviceTrace(ops=[("k", 0, 1_000_000_000), ("k", 500_000_000, 1_500_000_000)], start_ns=0,
                     end_ns=2_000_000_000)
    t = harness.TraceData({}, tr, {}, {})
    assert harness.load_metric("device.idle_pct.ks2d").read(t) == harness.load_metric("device.idle_pct").read(t) == 25.0
