"""The benchmark's arithmetic on synthetic pass times and a synthetic trace."""

import json
import statistics

import pytest

from furbench import stats, tracing


def test_rate_is_all_work_over_the_window():
    assert stats.rate(3 * 1024 * 1024 * 4, 0.5) == pytest.approx(25165824.0)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_p90_of_pass_times():
    times = [0.1] * 90 + [0.2] * 10
    assert stats.p90(times) == pytest.approx(0.11)
    assert stats.p90(range(1, 12)) == pytest.approx(10.0)
    assert stats.p90([0.3, 0.3]) == pytest.approx(0.3)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [1.0, 1.0, 1.02, 1.04, 1.04, 1.1]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_busy_and_idle_share_from_overlapping_intervals():
    ops = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    window = (0.0, 10.0)
    assert stats.busy_time(ops, window) == pytest.approx(4.0)
    assert stats.idle_share(ops, window) == pytest.approx(60.0)
    assert stats.idle_gaps(ops, window) == [(2.0, 3.0), (4.0, 9.0)]


def test_gaps_go_to_the_innermost_span():
    ops = [(0.0, 1.0), (2.0, 3.0), (5.0, 10.0)]
    spans = [("pass", 0.0, 10.0), ("bounce", 0.5, 4.0), ("shade", 1.0, 1.5)]
    by = dict(stats.gaps_by_span(ops, (0.0, 10.0), spans))
    assert by == {"shade": pytest.approx(1.0), "bounce": pytest.approx(2.0)}
    assert stats.innermost_span(spans, 11.0) == "outside spans"


def test_ops_by_name_sums_and_ranks():
    ops = [("a", 0.0, 1.0), ("b", 0.0, 3.0), ("a", 5.0, 7.0)]
    assert dict(stats.ops_by_name(ops)) == {"a": pytest.approx(3.0), "b": pytest.approx(3.0)}
    assert len(stats.ops_by_name(ops, top=1)) == 1


def test_read_trace_takes_device_ops_and_benchmark_spans(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "stream_kernel<1>", "ts": 1000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1600.0, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "furbench.pass", "ts": 900.0,
         "dur": 2000.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 900.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 950.0, "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = tracing.read_trace(str(path))
    assert tr["kernels"] == 1
    assert [n for n, _, _ in tr["ops"]] == ["stream_kernel<1>", "Memcpy HtoD"]
    assert tr["spans"] == [("pass", pytest.approx(9e-4), pytest.approx(2.9e-3))]
    ops = [(s, e) for _, s, e in tr["ops"]]
    assert stats.idle_share(ops, (9e-4, 2.9e-3)) == pytest.approx(100 * (1 - 5.1e-4 / 2e-3))
